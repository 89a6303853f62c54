"""Convolutional backbone — residual CNN, stride-16 feature map.

Counterpart of ``vdetlib_tpu/nn/backbone.py``. Convolutions run NCHW inside;
the public input and output are channels-last like the JAX module.

Two details the Flax layers fix and torch's defaults would change:

- Flax ``padding="SAME"`` pads a stride-2 layer asymmetrically (low side =
  total // 2): (2, 3) for the 7×7/2 stem at even sizes, (0, 1) for the 3×3/2
  convs and max-pool. :func:`same_pad` pads explicitly; torch's symmetric
  ``padding=k//2`` would shift the sampling grid by one pixel.
- Flax GroupNorm computes its statistics in float32 with
  Var = E[x²] − E[x]² (clipped at 0) and eps 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(x, kernel: int, stride: int, value: float = 0.0):
    """Pad an NCHW tensor the way Flax/XLA ``padding="SAME"`` does."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W first, then H
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class GroupNorm(nn.Module):
    """Flax-semantics GroupNorm over NCHW: f32 statistics, eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.groups = math.gcd(32, features)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        B, C, H, W = x.shape
        G = self.groups
        xf = x.float().reshape(B, G, C // G, H * W)
        mean = xf.mean((2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean((2, 3), keepdim=True) - mean * mean, min=0.0)
        # Flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(1, G, C // G, 1)
        y = (xf - mean) * mul + self.bias.float().reshape(1, G, C // G, 1)
        return y.reshape(B, C, H, W).to(x.dtype)


def conv_same(conv: nn.Conv2d, x, dtype):
    """Stride-aware SAME conv in ``dtype`` (weights cast like Flax ``dtype=``).

    A bias is added after the convolution's result is rounded to ``dtype``,
    as Flax does, not fused into the convolution."""
    k, s = conv.kernel_size[0], conv.stride[0]
    y = F.conv2d(same_pad(x, k, s), conv.weight.to(dtype), stride=s)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[:, None, None]
    return y


@dataclass(frozen=True)
class BackboneConfig:
    stem_features: int = 64
    stage_sizes: Sequence[int] = (2, 2, 2)  # blocks per stage (strides 4→8→16)
    stage_features: Sequence[int] = (128, 256, 512)
    dtype: torch.dtype = torch.bfloat16


class ResBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(in_features, features, 3, stride, bias=False)
        self.gn0 = GroupNorm(features)
        self.conv1 = nn.Conv2d(features, features, 3, 1, bias=False)
        self.gn1 = GroupNorm(features)
        # Flax adds the projection iff the residual's shape changes
        self.has_proj = in_features != features or stride != 1
        if self.has_proj:
            self.proj = nn.Conv2d(in_features, features, 1, stride, bias=False)
            self.proj_gn = GroupNorm(features)

    def forward(self, x):
        y = F.relu(self.gn0(conv_same(self.conv0, x, self.dtype)))
        y = self.gn1(conv_same(self.conv1, y, self.dtype))
        r = x
        if self.has_proj:
            r = self.proj_gn(conv_same(self.proj, x, self.dtype))
        return F.relu(y + r)


class Backbone(nn.Module):
    """Images (B, H, W, 3) float → features (B, ceil(H/16), ceil(W/16), C_out)."""

    stride = 16

    def __init__(self, config: BackboneConfig = BackboneConfig()):
        super().__init__()
        self.config = config
        dt = config.dtype
        self.stem = nn.Conv2d(3, config.stem_features, 7, 2, bias=False)
        self.stem_gn = GroupNorm(config.stem_features)
        blocks = []
        cin = config.stem_features
        for si, (n_blocks, feats) in enumerate(
            zip(config.stage_sizes, config.stage_features)
        ):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(ResBlock(cin, feats, stride, dt))
                cin = feats
        self.blocks = nn.ModuleList(blocks)

    @property
    def out_features(self) -> int:
        return self.config.stage_features[-1]

    def forward(self, x):
        dt = self.config.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(self.stem_gn(conv_same(self.stem, x, dt)))
        x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)  # stride 4
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 2, 3, 1)
