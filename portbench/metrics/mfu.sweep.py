"""The untraced window's model FLOPs (``yardstick/flops.py::fused_dispatch_flops``
over each finished video's valid frames) over (the window x the bf16 dense
peak) (%): the same frames and time as ``frames_per_s``."""

from portbench import architectures
from portbench.yardstick.flops import PEAK_BF16_FLOPS, fused_dispatch_flops


def read(ctx):
    c = ctx["config"]
    arch = architectures.of(c)
    flops = sum(sum(fused_dispatch_flops(arch, c["detector"], c["tracker"], c["fused"], t,
                                         c["max_rois"]).values()) for t in ctx["window_frames"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
