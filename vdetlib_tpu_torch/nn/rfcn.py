"""R-FCN on a bottleneck ResNet trunk: the per-frame detector of DFF and FGFA
on ImageNet VID (Dai, Li, He, Sun, arXiv:1605.06409, §2–§4; ResNet-101 of
He et al., arXiv:1512.03385, Table 1). The JAX package has no counterpart.

Trunk (MSRA's released ResNet v1, as R-FCN runs it):

- a 7×7/2 stem convolution, BN, ReLU and Caffe's 3×3/2 max-pool (no
  padding, the output size rounded up);
- four stages of bottleneck blocks, 1×1 → 3×3 → 1×1 with a residual add and
  a 1×1 projection where the block changes the shape; a stage's stride sits
  on its first block's first 1×1 convolution and on its projection;
- R-FCN's "à trous" conv5: the last stage keeps stride 1 and dilates every
  3×3 by ``conv5_dilation``, so the trunk ends at stride 16;
- every convolution followed by BN in its inference form, a per-channel
  scale and shift (:class:`Affine`); padding symmetric, ``k // 2`` times
  the dilation, as in Caffe.

Head: a 1×1 reduction to ``reduce_features`` with ReLU, then sibling 1×1
convolutions to k²·K position-sensitive class maps and 4k² box maps
(class-agnostic regression), PS-ROI pooling (eq. 1, :func:`psroi_pool`) and
average voting over the k² bins (eq. 2). Every class is given the same four
deltas. Channel ``(c·k + i)·k + j`` of a map set holds bin (i, j) of class
(or delta) c, the layout of R-FCN's released layer.

Number formats: trunk and reduction in ``config.dtype`` (bfloat16: float32
accumulation inside cuDNN), both map convolutions from float32 operands with
float32 results, pooling and voting in float32.

Each forward opens the spans ``detect.backbone`` (the trunk),
``detect.score_maps`` (the reduction and both map convolutions) and
``detect.psroi`` (pooling and voting); :func:`psroi_pool` counts its calls
and ROIs in ``psroi_pool.calls`` and ``psroi_pool.rois``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

STRIDE = 16
MIN_ROI_CELLS = 0.1  # R-FCN's layer widens a smaller ROI to this many cells


@dataclass(frozen=True)
class RFCNConfig:
    num_classes: int = 31  # ImageNet VID: 30 classes + background
    stem_features: int = 64
    stage_sizes: Sequence[int] = (3, 4, 23, 3)  # conv2..conv5 blocks
    bottleneck_features: Sequence[int] = (64, 128, 256, 512)
    stage_features: Sequence[int] = (256, 512, 1024, 2048)
    conv5_dilation: int = 2
    reduce_features: int = 1024
    ps_pool: int = 7  # k: k × k position-sensitive bins
    # py-faster-rcnn's BGR means; Caffe's unscaled pixels
    pixel_mean: tuple = (102.9801, 115.9465, 122.7717)
    pixel_scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16  # trunk and reduction


class Affine(nn.Module):
    """BatchNorm in its inference form over NCHW: ``x · weight + bias`` a channel."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return torch.addcmul(self.bias.to(x.dtype)[:, None, None], x,
                             self.weight.to(x.dtype)[:, None, None])


def _conv(conv: nn.Conv2d, x, dtype):
    """``conv`` with its weight in ``dtype`` and in ``x``'s channels-last layout."""
    w = conv.weight.to(dtype, memory_format=torch.channels_last)
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation)


def _conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int, dilation: int):
        super().__init__()
        self.conv1 = _conv1x1(cin, mid, stride)
        self.bn1 = Affine(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, 1, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = Affine(mid)
        self.conv3 = _conv1x1(mid, cout)
        self.bn3 = Affine(cout)
        self.has_proj = cin != cout or stride != 1
        if self.has_proj:
            self.proj = _conv1x1(cin, cout, stride)
            self.proj_bn = Affine(cout)

    def forward(self, x):
        dt = x.dtype
        y = F.relu_(self.bn1(_conv(self.conv1, x, dt)))
        y = F.relu_(self.bn2(_conv(self.conv2, y, dt)))
        y = self.bn3(_conv(self.conv3, y, dt))
        r = self.proj_bn(_conv(self.proj, x, dt)) if self.has_proj else x
        return F.relu_(y.add_(r))


class Trunk(nn.Module):
    """Images (B, 3, H, W) in ``config.dtype`` → features (B, C_out, H', W') at stride 16."""

    def __init__(self, config: RFCNConfig):
        super().__init__()
        self.conv1 = nn.Conv2d(3, config.stem_features, 7, 2, padding=3, bias=False)
        self.bn1 = Affine(config.stem_features)
        last = len(config.stage_sizes) - 1
        stages, cin = [], config.stem_features
        for si, (n, mid, out) in enumerate(zip(config.stage_sizes, config.bottleneck_features,
                                               config.stage_features)):
            stride = 2 if 0 < si < last else 1
            dil = config.conv5_dilation if si == last else 1
            stages.append(nn.Sequential(*[
                Bottleneck(cin if b == 0 else out, mid, out, stride if b == 0 else 1, dil)
                for b in range(n)]))
            cin = out
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = F.relu_(self.bn1(_conv(self.conv1, x, x.dtype)))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for stage in self.stages:
            x = stage(x)
        return x


def _c_round(x):
    """C's ``round``: halves away from zero (``torch.round`` rounds them to even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def psroi_bins(rois, k: int, height: int, width: int, stride: int = STRIDE):
    """Each ROI's k bins a side on the stride-``stride`` map, as R-FCN's layer
    places them: corners rounded to pixels, the end + 1, scaled by
    1/``stride``; bin i of a side spans ⌊i·s/k + start⌋ to ⌈(i+1)·s/k + start⌉,
    clipped to the map. rois (..., 4) pixel [x1, y1, x2, y2] → (y0, y1, x0,
    x1), each (..., k) int64."""
    r = _c_round(rois.float())
    scale = 1.0 / stride
    x_start, y_start = r[..., 0] * scale, r[..., 1] * scale
    x_end, y_end = (r[..., 2] + 1.0) * scale, (r[..., 3] + 1.0) * scale
    bin_w = torch.clamp(x_end - x_start, min=MIN_ROI_CELLS) / k
    bin_h = torch.clamp(y_end - y_start, min=MIN_ROI_CELLS) / k
    i = torch.arange(k, dtype=torch.float32, device=rois.device)

    def side(start, size, n):
        lo = torch.floor(i * size[..., None] + start[..., None])
        hi = torch.ceil((i + 1.0) * size[..., None] + start[..., None])
        return lo.clamp(0, n).long(), hi.clamp(0, n).long()

    y0, y1 = side(y_start, bin_h, height)
    x0, x1 = side(x_start, bin_w, width)
    return y0, y1, x0, x1


def psroi_pool(maps, rois, k: int, stride: int = STRIDE):
    """Position-sensitive ROI pooling (R-FCN eq. 1), batched over images.

    maps (B, H, W, G·k²) float32 with channel ``(g·k + i)·k + j`` for bin
    (i, j) of group g; rois (B, R, 4) pixel space → (B, R, G, k, k) float32,
    each bin the mean of its group's channel over the bin's cells, 0 for an
    empty bin. The sums come from a summed-area table of the maps formed in
    float64, so that each bin's four-corner difference is exact to float32's
    rounding (a float32 table would lose the low bits of a small bin to the
    map's running sum)."""
    B, H, W, Ch = maps.shape
    R = rois.shape[1]
    G = Ch // (k * k)
    psroi_pool.calls += 1
    psroi_pool.rois += B * R
    y0, y1, x0, x1 = psroi_bins(rois, k, H, W, stride)
    sat = maps.new_zeros((B, H + 1, W + 1, Ch), dtype=torch.float64)
    sat[:, 1:, 1:] = maps.double().cumsum(1).cumsum(2)
    flat = sat.view(B, -1)
    dev = maps.device
    ch = (torch.arange(G, device=dev)[:, None, None] * (k * k)
          + torch.arange(k, device=dev)[:, None] * k + torch.arange(k, device=dev))

    def corner(ys, xs):  # (B, R, k) rows over i, columns over j → (B, R, G, k, k)
        idx = (ys[:, :, None, :, None] * (W + 1) + xs[:, :, None, None, :]) * Ch + ch
        return flat.gather(1, idx.view(B, -1)).view(B, R, G, k, k)

    total = corner(y1, x1) - corner(y0, x1) - corner(y1, x0) + corner(y0, x0)
    area = ((y1 - y0)[:, :, :, None] * (x1 - x0)[:, :, None, :])[:, :, None]
    mean = total / area.clamp(min=1)
    return torch.where(area > 0, mean, torch.zeros_like(mean)).float()


psroi_pool.calls = 0
psroi_pool.rois = 0


class RFCN(nn.Module):
    """R-FCN: images (B, H, W, 3) preprocessed float, rois (B, R, 4) pixel space
    → class logits (B, R, K) float32, deltas (B, R, K, 4) float32."""

    stride = STRIDE

    def __init__(self, config: RFCNConfig = RFCNConfig()):
        super().__init__()
        self.config = config
        k2 = config.ps_pool ** 2
        self.trunk = Trunk(config)
        self.reduce = nn.Conv2d(config.stage_features[-1], config.reduce_features, 1)
        self.cls = nn.Conv2d(config.reduce_features, k2 * config.num_classes, 1)
        self.bbox = nn.Conv2d(config.reduce_features, k2 * 4, 1)

    def forward(self, images, rois):
        cfg = self.config
        K = cfg.num_classes
        with record_function("detect.backbone"):
            x = self.trunk(images.to(cfg.dtype).permute(0, 3, 1, 2))
        with record_function("detect.score_maps"):
            x = F.relu_(_conv(self.reduce, x, cfg.dtype)).float()
            # the sibling class and box maps as one product, class maps first
            w = torch.cat([self.cls.weight, self.bbox.weight]).float()
            b = torch.cat([self.cls.bias, self.bbox.bias]).float()
            maps = F.conv2d(x, w.contiguous(memory_format=torch.channels_last), b)
        with record_function("detect.psroi"):
            voted = psroi_pool(maps.permute(0, 2, 3, 1), rois, cfg.ps_pool).mean((-2, -1))
            scores = voted[..., :K]
            deltas = voted[..., None, K:].expand(voted.shape[:2] + (K, 4))
        return scores, deltas
