"""Kernel B's stage: the bound of ``fused.nms_dedup``'s work at the call's
shapes (``yardstick/work.py::fused_nms_dedup``) over all device time launched
under the span (%)."""

from portbench.yardstick.work import fused_nms_dedup


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("fused.nms_dedup")
    if not dev:
        return None
    f = ctx["config"]["fused"]
    slots = f["det_budget"] * (2 * f["mgp_window"] + 1)
    return 100.0 * sum(fused_nms_dedup(v["tp"], slots) for v in ctx["videos"]) / dev
