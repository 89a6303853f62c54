"""The repository's own detector (the ``base``, ``small`` and ``tiny``
presets): a residual basic-block backbone with GroupNorm at stride 16,
separable ROI align and a two-fc Fast R-CNN head.

The configuration's ``detector`` section states ``num_classes``,
``stem_features``, ``stage_sizes``, ``stage_features``, ``roi_pool``,
``head_hidden``, ``pixel_mean``, ``pixel_scale`` and ``backbone_dtype``. The
reference is :class:`portbench.reference.nets.Detector`.
"""

from __future__ import annotations

import torch

from portbench.harness.models import same
from portbench.reference.nets import Detector
from portbench.yardstick.flops import conv2d, roi_align_flops

STAGES = ("backbone", "head_hidden", "head_out", "roi_align")


def program(config: dict, device):
    """The port's ``Detector`` of the preset ``config["model"]``."""
    from vdetlib_tpu_torch.nn.detector import Detector as PortDetector
    from vdetlib_tpu_torch.nn.presets import detector_preset

    det_cfg = detector_preset(config["model"], num_classes=config["num_classes"])
    check_detector(det_cfg, config["detector"])
    with torch.device(device):
        return PortDetector(det_cfg).eval()


def check_detector(det_cfg, arch: dict) -> None:
    """Refuse a preset that is not the configuration file's detector."""
    bb = det_cfg.backbone
    got = {"num_classes": det_cfg.num_classes, "stem_features": bb.stem_features,
           "stage_sizes": list(bb.stage_sizes), "stage_features": list(bb.stage_features),
           "roi_pool": det_cfg.roi_pool, "head_hidden": det_cfg.head_hidden,
           "pixel_mean": list(det_cfg.pixel_mean), "pixel_scale": det_cfg.pixel_scale,
           "backbone_dtype": str(bb.dtype).replace("torch.", "")}
    same("detector", got, arch)


def shape_head(state: dict, weights: dict) -> dict:
    """Scale the classifier's and the regressor's kernels as ``weights`` says."""
    state["head.cls.weight"] = state["head.cls.weight"] * weights["cls_logit_scale"]
    state["head.bbox.weight"] = state["head.bbox.weight"] * weights["bbox_scale"]
    return state


def reference(arch: dict, prec) -> Detector:
    """The plain detector, every product in ``prec``'s formats."""
    return Detector(arch, prec)


def backbone_flops(det: dict, h: int, w: int) -> float:
    """Per-image conv FLOPs of the residual backbone."""
    total = 0.0
    h2, w2 = h // 2, w // 2
    total += conv2d(h2, w2, 7, 7, 3, det["stem_features"])
    hs, ws = h2 // 2, w2 // 2
    cin = det["stem_features"]
    for si, (n_blocks, feats) in enumerate(zip(det["stage_sizes"], det["stage_features"])):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            hs, ws = hs // stride, ws // stride
            total += conv2d(hs, ws, 3, 3, cin, feats)
            total += conv2d(hs, ws, 3, 3, feats, feats)
            if cin != feats or stride != 1:
                total += conv2d(hs, ws, 1, 1, cin, feats)
            cin = feats
    return total


def rcnn_head_flops(pool: int, c: int, hidden: int, num_classes: int, n_rois: int) -> float:
    d_in = pool * pool * c
    per_roi = (2.0 * d_in * hidden + 2.0 * hidden * hidden + 2.0 * hidden * num_classes
               + 2.0 * hidden * num_classes * 4)
    return n_rois * per_roi


def detect_flops(det: dict, h: int, w: int, n_rois: int) -> dict:
    """Backbone, ROI align on the stride-16 map and the head, one frame."""
    hf, wf = h // 16, w // 16
    cf = det["stage_features"][-1]
    return {"detect/backbone": backbone_flops(det, h, w),
            "detect/roi_align": roi_align_flops(hf, wf, cf, det["roi_pool"], n_rois),
            "detect/head": rcnn_head_flops(det["roi_pool"], cf, det["head_hidden"],
                                           det["num_classes"], n_rois)}
