"""Correlation tracker network — counterpart of ``vdetlib_tpu/nn/tracker_net.py``.

One conv pass computes dense stride-4 tracker features for every frame;
templates and search windows are ROI-aligned from that map, and the
normalized cross-correlation of a template over its search window gives
the new box (soft-argmax) and the confidence (peak). Every function here
is batched over leading lane axes, where the JAX package vmaps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vdetlib_tpu_torch.nn.backbone import GroupNorm, conv_same
from vdetlib_tpu_torch.nn.heads import roi_align


@dataclass(frozen=True)
class TrackerConfig:
    features: tuple = (32, 64, 96)
    out_features: int = 96
    template_pool: int = 8  # template is P×P feature bins
    search_factor: float = 2.0  # search window side = factor × box side
    dtype: torch.dtype = torch.bfloat16
    # scale adaptation: correlate at num_scales box scales per step, adopt
    # the best peak's scale with damping. 1 = off.
    num_scales: int = 1
    scale_step: float = 1.05
    scale_damping: float = 0.5
    scale_penalty: float = 0.975  # multiplier on non-unity scale peaks
    # EMA template adaptation (0.0 = frozen anchor template)
    template_eta: float = 0.0
    template_update_conf: float = 0.6

    @property
    def stride(self) -> int:
        return 2 ** min(2, len(self.features))

    @property
    def search_pool(self) -> int:
        return int(round(self.template_pool * self.search_factor))


class TrackerNet(nn.Module):
    """Frames (B, H, W, 3) float → dense features (B, H/4, W/4, C), stride 4."""

    def __init__(self, config: TrackerConfig = TrackerConfig()):
        super().__init__()
        self.config = config
        convs, gns = [], []
        cin = 3
        for i, feats in enumerate(config.features):
            convs.append(nn.Conv2d(cin, feats, 3, 2 if i < 2 else 1, bias=False))
            gns.append(GroupNorm(feats))
            cin = feats
        self.convs = nn.ModuleList(convs)
        self.gns = nn.ModuleList(gns)
        self.out = nn.Conv2d(cin, config.out_features, 1)

    @property
    def stride(self) -> int:
        return self.config.stride

    def forward(self, x):
        dt = self.config.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for conv, gn in zip(self.convs, self.gns):
            x = F.relu(gn(conv_same(conv, x, dt)))
        x = conv_same(self.out, x, dt)
        return x.permute(0, 2, 3, 1)


def extract_template(feat, box, cfg: TrackerConfig):
    """Anchor-box template features, L2-normalized.

    feat (..., h, w, C) with box (..., 4) → (..., P, P, C) float32: the
    leading axes pair each box with its own feature map; or with box
    (..., L, 4) → (..., L, P, P, C): L boxes on each map."""
    lead = box.shape[:-1]
    f = feat.reshape((-1,) + feat.shape[-3:])
    b = box.reshape(f.shape[0], -1, 4)
    pooled = roi_align(f, b, stride=cfg.stride, pool=cfg.template_pool).float()
    norm = torch.sqrt(torch.sum(pooled * pooled, dim=(-3, -2, -1), keepdim=True) + 1e-6)
    return (pooled / norm).reshape(lead + pooled.shape[-3:])


def search_window(box, factor: float):
    """Box → centered window scaled by ``factor`` (same center)."""
    cx = 0.5 * (box[..., 0] + box[..., 2])
    cy = 0.5 * (box[..., 1] + box[..., 3])
    w = (box[..., 2] - box[..., 0]) * factor
    h = (box[..., 3] - box[..., 1]) * factor
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def correlate(template, search_feat):
    """Normalized cross-correlation of each lane's template over its window.

    Args:
      template: (..., P, P, C) L2-normalized.
      search_feat: (..., Q, Q, C), same leading lane axes.
    Returns:
      (..., Q-P+1, Q-P+1) response in [-1, 1] (cosine similarity per position).

    A VALID conv per lane, run as one grouped conv over all lanes, in float32.
    """
    lead = template.shape[:-3]
    P, C = template.shape[-3], template.shape[-1]
    Q = search_feat.shape[-3]
    s = search_feat.float().reshape((-1, Q, Q, C)).permute(0, 3, 1, 2)  # (L, C, Q, Q)
    L = s.shape[0]
    k = template.float().reshape((L, P, P, C)).permute(0, 3, 1, 2)  # (L, C, P, P)
    resp = F.conv2d(s.reshape(1, L * C, Q, Q), k, groups=L)[0]  # (L, R, R)
    # local L2 norm of each search patch (window sum of squares)
    ones = torch.ones((1, 1, P, P), dtype=torch.float32, device=s.device)
    sq = F.conv2d((s * s).sum(1, keepdim=True), ones)[:, 0]  # (L, R, R)
    out = resp / torch.sqrt(sq + 1e-6)
    return out.reshape(lead + out.shape[-2:])


def soft_argmax_2d(resp, temperature: float = 50.0):
    """Response maps (..., H, W) → soft peak (py, px) (sub-bin) and peak value."""
    H, W = resp.shape[-2:]
    w = torch.softmax(temperature * resp.reshape(resp.shape[:-2] + (H * W,)), dim=-1)
    w = w.reshape(resp.shape)
    ys = torch.arange(H, dtype=torch.float32, device=resp.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=resp.device)[None, :]
    py = torch.sum(w * ys, dim=(-2, -1))
    px = torch.sum(w * xs, dim=(-2, -1))
    peak = torch.amax(resp, dim=(-2, -1))
    return py, px, peak
