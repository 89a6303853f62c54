"""The window's full chunks' model FLOPs (``yardstick/flops.py::
stream_chunk_flops``) over (their summed latencies x the bf16 dense peak) (%)."""

from portbench import architectures
from portbench.yardstick.flops import PEAK_BF16_FLOPS, stream_chunk_flops


def read(ctx):
    ms = ctx["chunks_ms"]
    if not ms:
        return None
    c = ctx["config"]
    flops = sum(stream_chunk_flops(architectures.of(c), c["detector"], c["tracker"], c["stream"],
                                   c["image_hw"]).values())
    return 100.0 * flops * len(ms) / (sum(ms) / 1e3 * PEAK_BF16_FLOPS)
