"""PS-ROI pooling and voting: the least time their work needs on the card
(``architectures/rfcn_r101.py::psroi_work`` for every frame the detector
processed, the bucket's padding included; bytes at HBM speed or float32
operations at the SIMT peak, the larger) over all device time launched
under ``detect.psroi`` (%)."""

from portbench import architectures
from portbench.yardstick.work import bound_s


def read(ctx):
    dev = ctx["trace"]["span_device_s"].get("detect.psroi")
    if not dev:
        return None
    c = ctx["config"]
    h, w = c["fused"]["image_hw"]
    n_bytes, n_ops = architectures.of(c).psroi_work(c["detector"], h, w, c["max_rois"])
    frames = sum(v["tp"] for v in ctx["videos"])
    return 100.0 * bound_s(frames * n_bytes, frames * n_ops) / dev
