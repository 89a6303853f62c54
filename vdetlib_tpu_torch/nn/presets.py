"""Named detector configurations (``base``, ``small`` and ``tiny`` have the
widths of ``vdetlib_tpu/nn/presets.py``; the R-FCN presets are the port's
own) and the one constructor for either kind of configuration."""

from __future__ import annotations

from torch import nn

from vdetlib_tpu_torch.nn.backbone import BackboneConfig
from vdetlib_tpu_torch.nn.detector import Detector, DetectorConfig
from vdetlib_tpu_torch.nn.rfcn import RFCN, RFCNConfig


def detector_preset(name: str, num_classes: int = 31, **backbone_kw):
    """A ``DetectorConfig`` or, for ``rfcn_*``, an ``RFCNConfig``;
    ``backbone_kw`` overrides BackboneConfig fields (e.g. ``dtype``), or
    RFCNConfig fields for the R-FCN presets."""
    if name == "base":
        # ~38M params, resnet18-class capacity — the flagship VID detector.
        return DetectorConfig(num_classes=num_classes, backbone=BackboneConfig(**backbone_kw))
    if name == "small":
        return DetectorConfig(
            num_classes=num_classes,
            backbone=BackboneConfig(
                stem_features=32, stage_sizes=(1, 1, 1),
                stage_features=(64, 128, 256), **backbone_kw,
            ),
            head_hidden=512,
        )
    if name == "tiny":
        # test-size net: same code paths.
        return DetectorConfig(
            num_classes=num_classes,
            backbone=BackboneConfig(
                stem_features=16, stage_sizes=(1, 1, 1),
                stage_features=(32, 64, 128), **backbone_kw,
            ),
            head_hidden=128,
        )
    if name == "rfcn_r101":
        # R-FCN on ResNet-101 at its published widths (arXiv:1605.06409, 1512.03385)
        return RFCNConfig(num_classes=num_classes, **backbone_kw)
    if name == "rfcn_tiny":
        # test-size R-FCN: the same code paths (bottlenecks, dilated conv5, k = 7)
        return RFCNConfig(num_classes=num_classes, stem_features=8, stage_sizes=(1, 1, 1, 1),
                          bottleneck_features=(4, 8, 8, 16), stage_features=(16, 32, 32, 64),
                          reduce_features=32, **backbone_kw)
    raise ValueError(f"unknown detector preset: {name}")


def build_detector(config) -> nn.Module:
    """The detector a preset's configuration describes: ``RFCN`` for an
    ``RFCNConfig``, else ``Detector``."""
    return RFCN(config) if isinstance(config, RFCNConfig) else Detector(config)
