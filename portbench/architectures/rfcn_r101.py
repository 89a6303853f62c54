"""R-FCN with a bottleneck ResNet trunk (the ``rfcn_r101`` and ``rfcn_tiny``
presets): ResNet v1 with conv5 dilated at stride 16, a 1×1 reduction,
position-sensitive class and box maps, PS-ROI pooling and average voting
(Dai et al., arXiv:1605.06409; the per-frame detector of DFF and FGFA on
ImageNet VID).

The configuration's ``detector`` section states ``num_classes``,
``stem_features``, ``stage_sizes``, ``bottleneck_features``,
``stage_features``, ``conv5_dilation``, ``reduce_features``, ``ps_pool``,
``pixel_mean``, ``pixel_scale`` and ``trunk_dtype``. The reference is
:class:`portbench.reference.rfcn.RFCN`.
"""

from __future__ import annotations

import torch

from portbench.harness.models import same
from portbench.reference.rfcn import RFCN
from portbench.yardstick.flops import conv2d

STAGES = ("backbone", "reduce", "score_maps", "psroi")


def program(config: dict, device):
    """The port's R-FCN of the preset ``config["model"]``, built by the port's
    own constructor; refused where the port has no R-FCN."""
    try:
        from vdetlib_tpu_torch.nn.presets import build_detector, detector_preset
    except ImportError as e:
        raise SystemExit(f"the port builds no R-FCN detector: {e}") from None

    det_cfg = detector_preset(config["model"], num_classes=config["num_classes"])
    got = {"num_classes": det_cfg.num_classes, "stem_features": det_cfg.stem_features,
           "stage_sizes": list(det_cfg.stage_sizes),
           "bottleneck_features": list(det_cfg.bottleneck_features),
           "stage_features": list(det_cfg.stage_features),
           "conv5_dilation": det_cfg.conv5_dilation,
           "reduce_features": det_cfg.reduce_features, "ps_pool": det_cfg.ps_pool,
           "pixel_mean": list(det_cfg.pixel_mean), "pixel_scale": det_cfg.pixel_scale,
           "trunk_dtype": str(det_cfg.dtype).replace("torch.", "")}
    same("detector", got, config["detector"])
    with torch.device(device):
        return build_detector(det_cfg).eval()


def shape_head(state: dict, weights: dict) -> dict:
    """Scale the class maps' and the box maps' kernels as ``weights`` says;
    the background's k² class maps (channels 0..k²-1) take
    ``weights["background_scale"]`` on top of ``cls_logit_scale``."""
    k2 = state["bbox.weight"].shape[0] // 4
    cls = state["cls.weight"] * weights["cls_logit_scale"]
    cls[:k2] = cls[:k2] * weights["background_scale"]
    state["cls.weight"] = cls
    state["bbox.weight"] = state["bbox.weight"] * weights["bbox_scale"]
    return state


def reference(arch: dict, prec) -> RFCN:
    """The plain R-FCN, every product in ``prec``'s formats."""
    return RFCN(arch, prec)


def conv_out(n: int, k: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def trunk(det: dict, h: int, w: int) -> tuple[float, int, int]:
    """Per-image conv FLOPs of the trunk → (FLOPs, map rows, map columns)."""
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    total = conv2d(h, w, 7, 7, 3, det["stem_features"])
    h, w = -(-(h - 3) // 2) + 1, -(-(w - 3) // 2) + 1  # Caffe's max-pool, rounded up
    cin = det["stem_features"]
    last = len(det["stage_sizes"]) - 1
    for si, (n, mid, out) in enumerate(zip(det["stage_sizes"], det["bottleneck_features"],
                                           det["stage_features"])):
        for b in range(n):
            stride = 2 if (b == 0 and 0 < si < last) else 1
            h, w = conv_out(h, 1, stride, 0), conv_out(w, 1, stride, 0)
            total += (conv2d(h, w, 1, 1, cin, mid) + conv2d(h, w, 3, 3, mid, mid)
                      + conv2d(h, w, 1, 1, mid, out))
            if cin != out or stride != 1:
                total += conv2d(h, w, 1, 1, cin, out)
            cin = out
    return total, h, w


def psroi_work(det: dict, h: int, w: int, n_rois: int) -> tuple[float, float]:
    """One frame's PS-ROI pooling and voting → (bytes, operations): the class
    and box maps read once (float32), the ROIs read, the logits and the four
    deltas written; the operations of the summed-area form (two adds a map
    element, three adds and a division a bin and group, one operation a bin
    and group for the vote), the least that this pooling needs whatever the
    ROIs' sizes."""
    _, hf, wf = trunk(det, h, w)
    k2, groups = det["ps_pool"] ** 2, det["num_classes"] + 4
    n_bytes = 4.0 * (hf * wf * k2 * groups + n_rois * 4 + n_rois * groups)
    n_ops = 2.0 * hf * wf * k2 * groups + n_rois * groups * k2 * (4 + 1)
    return n_bytes, n_ops


def detect_flops(det: dict, h: int, w: int, n_rois: int) -> dict:
    """The trunk, PS-ROI pooling and voting, the reduction and the maps, one frame."""
    flops, hf, wf = trunk(det, h, w)
    red, c_out = det["reduce_features"], det["stage_features"][-1]
    maps = det["ps_pool"] ** 2 * (det["num_classes"] + 4)
    return {"detect/backbone": flops,
            "detect/roi_align": psroi_work(det, h, w, n_rois)[1],
            "detect/head": conv2d(hf, wf, 1, 1, c_out, red) + conv2d(hf, wf, 1, 1, red, maps)}
