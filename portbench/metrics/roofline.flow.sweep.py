"""Kernel A's stage: the bound of ``fused.flow``'s work at the call's shapes
(``yardstick/work.py::fused_flow``) over all device time launched under the
span (%)."""

from portbench.yardstick.work import fused_flow


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("fused.flow")
    if not dev:
        return None
    f = ctx["config"]["fused"]
    bound = sum(fused_flow(v["tp"], f["image_hw"], f["flow_preset"]) for v in ctx["videos"])
    return 100.0 * bound / dev
