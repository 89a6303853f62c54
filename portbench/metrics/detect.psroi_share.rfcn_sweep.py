"""Share of detection's device time launched under ``detect.psroi`` (R-FCN's
PS-ROI pooling and voting) (%): over all device time under ``fused.detect``."""


def read(ctx):
    dev = ctx["trace"]["span_device_s"]
    if not dev.get("detect.psroi") or not dev.get("fused.detect"):
        return None
    return 100.0 * dev["detect.psroi"] / dev["fused.detect"]
