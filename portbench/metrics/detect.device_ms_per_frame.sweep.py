"""Device time launched under ``fused.detect`` per valid frame (ms/frame)."""


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("fused.detect")
    if not dev:
        return None
    return 1e3 * dev / sum(v["t"] for v in ctx["videos"])
