"""Kernels A and B's stages: the bound of ``stream.mgp`` and ``stream.mgp_nms``'s
work over the traced video's chunks (``yardstick/work.py::stream_mgp``) over
all device time launched under the two spans (%)."""

from portbench.yardstick.work import stream_mgp


def read(ctx):
    spans = ctx["trace"]["span_device_s"]
    dev = spans.get("stream.mgp", 0.0) + spans.get("stream.mgp_nms", 0.0)
    if not dev:
        return None
    c = ctx["config"]
    s = c["stream"]
    per = s["num_classes"] - 1
    valid = ctx["mgp_valid"]
    bound, off = 0.0, 0
    for n in ctx["traced_chunk_sizes"]:
        bound += stream_mgp(s["chunk"], c["image_hw"], per, s["max_rois"], s["flow_preset"],
                            valid[off:off + n * per])
        off += n * per
    return 100.0 * bound / dev
