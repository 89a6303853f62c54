"""Kernel F's stage: the bound of ``fused.track_rounds``'s work at the call's
shapes (``yardstick/work.py::fused_track_rounds``) over all device time
launched under the span (%)."""

from portbench.yardstick.work import fused_track_rounds


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("fused.track_rounds")
    if not dev:
        return None
    c = ctx["config"]
    bound = sum(fused_track_rounds(v["tp"], c["image_hw"], c["tracker"], c["fused"])
                for v in ctx["videos"])
    return 100.0 * bound / dev
