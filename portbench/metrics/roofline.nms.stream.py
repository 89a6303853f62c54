"""Kernel C's stage: the bound of ``stream.nms``'s work over the traced video's
chunks (``yardstick/work.py::stream_nms``, the valid slots counted from the
emitted scores) over all device time launched under the span (%)."""

from portbench.yardstick.work import stream_nms


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("stream.nms")
    if not dev:
        return None
    s = ctx["config"]["stream"]
    per = s["num_classes"] - 1
    valid = ctx["nms_valid"]
    bound, off = 0.0, 0
    for n in ctx["traced_chunk_sizes"]:
        bound += stream_nms(s["chunk"], per, s["max_rois"], valid[off:off + n * per])
        off += n * per
    return 100.0 * bound / dev
