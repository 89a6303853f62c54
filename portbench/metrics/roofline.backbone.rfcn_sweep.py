"""R-FCN's trunk: its ``detect/backbone`` FLOPs for every frame the detector
processed (the bucket's padding included) over (the device time launched
under ``detect.backbone`` x the bf16 dense peak) (%)."""

from portbench import architectures
from portbench.yardstick.flops import PEAK_BF16_FLOPS


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("detect.backbone")
    if not dev:
        return None
    c = ctx["config"]
    h, w = c["fused"]["image_hw"]
    per_frame = architectures.of(c).detect_flops(c["detector"], h, w, c["max_rois"])
    frames = sum(v["tp"] for v in ctx["videos"])
    return 100.0 * frames * per_frame["detect/backbone"] / (dev * PEAK_BF16_FLOPS)
