"""Named detector configurations (same widths as ``vdetlib_tpu/nn/presets.py``)."""

from __future__ import annotations

from vdetlib_tpu_torch.nn.backbone import BackboneConfig
from vdetlib_tpu_torch.nn.detector import DetectorConfig


def detector_preset(name: str, num_classes: int = 31, **backbone_kw) -> DetectorConfig:
    """``backbone_kw`` overrides BackboneConfig fields (e.g. ``dtype``)."""
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
    raise ValueError(f"unknown detector preset: {name}")
