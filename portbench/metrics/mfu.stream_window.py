"""The untraced window's model FLOPs over (the window x the bf16 dense peak)
(%): the same videos and time as ``stream_frames_per_s``. A video of ``t``
frames costs ``ceil(t / chunk)`` chunks (``yardstick/flops.py::
stream_chunk_flops``; a short last chunk runs padded to a full one) and its
video-end seq-NMS over the MGP's three slots a proposal (``seq_nms_flops``)."""

from portbench import architectures
from portbench.yardstick.flops import PEAK_BF16_FLOPS, seq_nms_flops, stream_chunk_flops


def read(ctx):
    c = ctx["config"]
    s = c["stream"]
    chunk = sum(stream_chunk_flops(architectures.of(c), c["detector"], c["tracker"], s,
                                   c["image_hw"]).values())
    n = 3 * s["max_rois"] if s["mgp"] else s["max_rois"]
    flops = sum(-(-t // s["chunk"]) * chunk + seq_nms_flops(t, n, s["num_classes"] - 1,
                                                           s["max_paths"])
                for t in ctx["window_frames"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
