"""R-FCN on a bottleneck ResNet trunk in plain PyTorch, the benchmark's frozen
reference for the ``rfcn_r101`` architecture.

Written from the paper (Dai et al., arXiv:1605.06409, §2–§4, eq. 1–2) and
R-FCN's released PS-ROI pooling layer, importing nothing of the port: NCHW
convolutions with Caffe's symmetric padding (``k // 2`` times the dilation),
each followed by BN in its inference form (a per-channel scale and shift),
Caffe's 3×3/2 max-pool rounded up, bottleneck blocks with the stride on the
first 1×1 and the projection, conv5 at stride 1 and dilated; a 1×1
reduction with ReLU, sibling 1×1 convolutions to the class and box maps,
PS-ROI pooling one bin at a time over every ROI of a batch (a bin's cells
selected by 0/1 masks, summed by two contractions) and average voting. The
deltas are class-agnostic: every class gets the same four.

Every product's number format comes from :class:`~portbench.reference.
precision.Precisions`: ``backbone`` (the trunk), ``reduce``, ``score_maps``
(both map convolutions) and ``psroi`` (the pooled sums). The parameter names
are the port's, so one state dict loads into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Prec, Precisions

STRIDE = 16
MIN_ROI_CELLS = 0.1


class Affine(nn.Module):
    """BN in its inference form: ``bias + x · weight`` a channel (NCHW)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, p: Prec):
        return torch.addcmul(p.cast(self.bias)[:, None, None], x, p.cast(self.weight)[:, None, None])


def conv(layer: nn.Conv2d, x, p: Prec):
    """Caffe's convolution with operands in ``p``: padding ``k // 2`` times the
    dilation on every side; a bias added to the result in ``p``'s type."""
    k, d = layer.kernel_size[0], layer.dilation[0]
    bias = None if layer.bias is None else p.cast(layer.bias)
    return F.conv2d(p.cast(x), p.cast(layer.weight), bias, layer.stride, (k // 2) * d, d)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1, stride, bias=False)
        self.bn1 = Affine(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, 1, dilation=dilation, bias=False)
        self.bn2 = Affine(mid)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = Affine(cout)
        self.has_proj = cin != cout or stride != 1
        if self.has_proj:
            self.proj = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.proj_bn = Affine(cout)

    def forward(self, x, p: Prec):
        y = F.relu(self.bn1(conv(self.conv1, x, p), p))
        y = F.relu(self.bn2(conv(self.conv2, y, p), p))
        y = self.bn3(conv(self.conv3, y, p), p)
        r = self.proj_bn(conv(self.proj, x, p), p) if self.has_proj else x
        return F.relu(y + r)


class Trunk(nn.Module):
    """ResNet v1 with bottlenecks as R-FCN runs it: (B, 3, H, W) → (B, C, H/16, W/16)."""

    def __init__(self, arch: dict):
        super().__init__()
        self.conv1 = nn.Conv2d(3, arch["stem_features"], 7, 2, bias=False)
        self.bn1 = Affine(arch["stem_features"])
        n_stages = len(arch["stage_sizes"])
        stages, cin = [], arch["stem_features"]
        for si in range(n_stages):
            n, mid, out = (arch["stage_sizes"][si], arch["bottleneck_features"][si],
                           arch["stage_features"][si])
            conv5 = si == n_stages - 1
            stride = 1 if si == 0 or conv5 else 2
            dilation = arch["conv5_dilation"] if conv5 else 1
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, mid, out, stride if b == 0 else 1, dilation))
                cin = out
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x, p: Prec):
        x = F.relu(self.bn1(conv(self.conv1, x, p), p))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for stage in self.stages:
            for block in stage:
                x = block(x, p)
        return x


def c_round(x):
    """C's ``round``: halves away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def bin_bounds(rois, k: int, height: int, width: int):
    """R-FCN's layer: a ROI's corners rounded, its end + 1, scaled by 1/16,
    widened to at least 0.1 cell; bin i of a side from ⌊i·s/k + start⌋ to
    ⌈(i+1)·s/k + start⌉, clipped to the map, in float32 → (y0, y1, x0, x1),
    each (..., k) int64."""
    r = c_round(rois.float())
    scale = 1.0 / STRIDE
    x_start, y_start = r[..., 0] * scale, r[..., 1] * scale
    x_end, y_end = (r[..., 2] + 1.0) * scale, (r[..., 3] + 1.0) * scale
    bin_w = torch.clamp(x_end - x_start, min=MIN_ROI_CELLS) / k
    bin_h = torch.clamp(y_end - y_start, min=MIN_ROI_CELLS) / k
    i = torch.arange(k, dtype=torch.float32, device=rois.device)
    y0 = torch.floor(i * bin_h[..., None] + y_start[..., None]).clamp(0, height).long()
    y1 = torch.ceil((i + 1.0) * bin_h[..., None] + y_start[..., None]).clamp(0, height).long()
    x0 = torch.floor(i * bin_w[..., None] + x_start[..., None]).clamp(0, width).long()
    x1 = torch.ceil((i + 1.0) * bin_w[..., None] + x_start[..., None]).clamp(0, width).long()
    return y0, y1, x0, x1


def psroi_pool(maps, rois, k: int, p: Prec):
    """PS-ROI pooling (eq. 1), one bin at a time over every ROI: maps (B, H,
    W, G·k²) with channel ``(g·k + i)·k + j`` for bin (i, j) of group g, rois
    (B, R, 4) → (B, R, G, k, k) float32, the mean of the bin's cells (its
    sum formed from operands in ``p``, float32 accumulation), 0 where the
    bin is empty."""
    B, H, W, Ch = maps.shape
    G = Ch // (k * k)
    y0, y1, x0, x1 = bin_bounds(rois, k, H, W)
    hs = torch.arange(H, device=maps.device)
    ws = torch.arange(W, device=maps.device)
    f = p.cast(maps).float()
    groups = torch.arange(G, device=maps.device) * (k * k)
    out = torch.zeros(rois.shape[:2] + (G, k, k), dtype=torch.float32, device=maps.device)
    for i in range(k):
        in_y = ((hs >= y0[..., i, None]) & (hs < y1[..., i, None])).float()  # (B, R, H)
        for j in range(k):
            in_x = ((ws >= x0[..., j, None]) & (ws < x1[..., j, None])).float()  # (B, R, W)
            cells = f[..., groups + i * k + j]  # (B, H, W, G)
            rows = torch.einsum("brw,bhwg->brhg", in_x, cells)
            total = torch.einsum("brh,brhg->brg", in_y, rows)
            area = ((y1[..., i] - y0[..., i]) * (x1[..., j] - x0[..., j]))[..., None]
            out[..., i, j] = torch.where(area > 0, total / area.clamp(min=1),
                                         torch.zeros_like(total))
    return out


class RFCN(nn.Module):
    """R-FCN; ``arch`` is a configuration's ``detector`` section, ``prec`` its
    formats. forward(images (B, H, W, 3) float, rois (B, R, 4)) → logits
    (B, R, K) float32, deltas (B, R, K, 4) float32."""

    def __init__(self, arch: dict, prec: Precisions):
        super().__init__()
        self.arch = arch
        self.prec = prec
        k2, K = arch["ps_pool"] ** 2, arch["num_classes"]
        self.trunk = Trunk(arch)
        self.reduce = nn.Conv2d(arch["stage_features"][-1], arch["reduce_features"], 1)
        self.cls = nn.Conv2d(arch["reduce_features"], k2 * K, 1)
        self.bbox = nn.Conv2d(arch["reduce_features"], k2 * 4, 1)

    def forward(self, images, rois):
        prec = self.prec
        k, K = self.arch["ps_pool"], self.arch["num_classes"]
        x = self.trunk(images.to(prec.backbone.dtype).permute(0, 3, 1, 2), prec.backbone)
        x = F.relu(conv(self.reduce, x.to(prec.reduce.dtype), prec.reduce)).float()
        cls_maps = conv(self.cls, x, prec.score_maps).float().permute(0, 2, 3, 1)
        box_maps = conv(self.bbox, x, prec.score_maps).float().permute(0, 2, 3, 1)
        logits = psroi_pool(cls_maps, rois, k, prec.psroi).mean((-2, -1))
        deltas = psroi_pool(box_maps, rois, k, prec.psroi).mean((-2, -1))
        return logits, deltas[:, :, None, :].expand(logits.shape + (4,))
