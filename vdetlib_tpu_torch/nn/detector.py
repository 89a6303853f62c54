"""Assembled detector: backbone + ROI head, batched over (frames, proposals).

Counterpart of ``vdetlib_tpu/nn/detector.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from vdetlib_tpu_torch.nn.backbone import Backbone, BackboneConfig
from vdetlib_tpu_torch.nn.heads import RCNNHead, roi_align


@dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 31  # ImageNet VID: 30 classes + background
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    roi_pool: int = 7
    head_hidden: int = 1024
    # Preprocessing constants (reference Caffe convention: BGR, mean subtract).
    pixel_mean: tuple = (102.98, 115.95, 122.77)  # BGR
    pixel_scale: float = 1.0


class Detector(nn.Module):
    def __init__(self, config: DetectorConfig = DetectorConfig()):
        super().__init__()
        self.config = config
        self.backbone = Backbone(config.backbone)
        P = config.roi_pool
        self.head = RCNNHead(
            P * P * self.backbone.out_features, config.num_classes,
            hidden=config.head_hidden,
        )

    def forward(self, images, rois):
        """images (B, H, W, 3) preprocessed float; rois (B, R, 4) pixel space →
        scores (B, R, K) f32 logits, deltas (B, R, K, 4) f32."""
        feats = self.backbone(images)  # (B, h, w, C) bf16
        pooled = roi_align(feats, rois, stride=Backbone.stride, pool=self.config.roi_pool)
        return self.head(pooled)


def preprocess_images(images_u8, config: DetectorConfig):
    """uint8 BGR (B, H, W, 3) → float32, mean-subtracted."""
    mean = torch.tensor(config.pixel_mean, dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() - mean) * config.pixel_scale
