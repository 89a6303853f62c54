"""ROI align + Fast R-CNN head (class scores + per-class bbox deltas).

Counterpart of ``vdetlib_tpu/nn/heads.py``. ROI align is the separable
bilinear-matmul form — per ROI ``pooled = Wy · F · Wxᵀ`` with Wy (P, H) and
Wx (P, W) holding the 1-D bilinear kernels at the bin centres — batched over
(image, roi) as two ``einsum`` contractions. The JAX module's ``fused=True``
layout is a recorded negative result there and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _bilinear_weights(starts, ends, size: int, pool: int):
    """1-D bilinear interpolation matrix for one ROI axis → (..., P, size)."""
    starts = starts.float()
    ends = ends.float()
    bin_w = (ends - starts) / pool
    ar = torch.arange(pool, dtype=torch.float32, device=starts.device)
    centers = starts[..., None] + (ar + 0.5) * bin_w[..., None]  # (..., P)
    # ROI-align convention: sample at center - 0.5 in pixel-center coords.
    pos = torch.clamp(centers - 0.5, 0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=starts.device)
    return torch.clamp(1.0 - torch.abs(pos[..., :, None] - grid), min=0.0)


def roi_align(features, boxes, stride: int, pool: int = 7, compute_dtype=None):
    """Separable bilinear ROI align, batched over images.

    Args:
      features: (G, H, W, C) feature maps (or one (H, W, C) map).
      boxes: (G, R, 4) pixel-space [x1, y1, x2, y2] (or (R, 4)).
      stride: image pixels per feature cell.
      pool: output bins P.
      compute_dtype: matmul operand dtype; default float32. With bfloat16
        the operands are rounded to bf16 and each contraction accumulates
        in float32, and the first one's result is rounded to bf16 before the
        second, as the JAX form does with ``preferred_element_type=f32`` +
        ``astype``.
    Returns:
      (G, R, P, P, C) pooled features (or (R, P, P, C)), in ``features.dtype``.
    """
    single = features.dim() == 3
    if single:
        features, boxes = features[None], boxes[None]
    G, H, W, C = features.shape
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    b = boxes.float() / stride
    wy = _bilinear_weights(b[..., 1], b[..., 3], H, pool).to(cdt).float()  # (G, R, P, H)
    wx = _bilinear_weights(b[..., 0], b[..., 2], W, pool).to(cdt).float()  # (G, R, P, W)
    f = features.to(cdt).float()
    pooled = torch.einsum("grph,ghwc->grpwc", wy, f).to(cdt).float()
    pooled = torch.einsum("grqw,grpwc->grpqc", wx, pooled)
    pooled = pooled.to(features.dtype)
    return pooled[0] if single else pooled


class _PooledDense(nn.Linear):
    """First head layer over the pooled (..., P, P, C) tensor (the JAX ``_PooledDense``).

    The input is flattened in (p, q, c) order, the row order of the Flax
    kernel; operands are rounded to ``dtype``, the product accumulates in
    float32 with the float32 bias, and the result is cast to ``dtype`` —
    the JAX ``einsum(..., preferred_element_type=f32) + bias``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.bfloat16):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        x = x.flatten(-3).to(dt).float()
        return F.linear(x, self.weight.to(dt).float(), self.bias.float()).to(dt)


class RCNNHead(nn.Module):
    """Pooled ROI features (..., P, P, C) → scores (..., K), deltas (..., K, 4)."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 1024,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.fc0 = _PooledDense(in_features, hidden, dtype)
        self.fc1 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, num_classes)
        self.bbox = nn.Linear(hidden, num_classes * 4)

    def forward(self, roi_feats):
        dt = self.dtype
        x = F.relu(self.fc0(roi_feats))
        # Flax Dense at bf16: the product rounds to bf16, then a bf16 bias add
        x = F.linear(x.float(), self.fc1.weight.to(dt).float()).to(dt)
        x = F.relu(x + self.fc1.bias.to(dt))
        x = x.float()
        scores = F.linear(x, self.cls.weight.float(), self.cls.bias.float())
        deltas = F.linear(x, self.bbox.weight.float(), self.bbox.bias.float())
        deltas = deltas.reshape(deltas.shape[:-1] + (self.num_classes, 4))
        return scores, deltas
