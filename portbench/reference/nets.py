"""The detector and the tracker network in plain PyTorch.

A frozen copy of the port's plain modules (the residual backbone with Flax
SAME padding and Flax GroupNorm, the separable ROI align, the Fast R-CNN
head, the tracker's conv features and its NCC update), with every product's
number format taken from :class:`~portbench.reference.precision.Precisions`
instead of fixed dtypes. At the configuration's own formats each stage runs
the same operations in the same order as the port's plain version. The
parameter names equal the port's modules', so one state dict loads into
both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Prec, Precisions

DET_STRIDE = 16


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
    """Flax-semantics GroupNorm over NCHW: float32 statistics, eps 1e-6."""

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
        mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(1, G, C // G, 1)
        y = (xf - mean) * mul + self.bias.float().reshape(1, G, C // G, 1)
        return y.reshape(B, C, H, W).to(x.dtype)


def conv_same(conv: nn.Conv2d, x, p: Prec):
    """SAME conv with operands in ``p``; a bias is added after the product."""
    k, s = conv.kernel_size[0], conv.stride[0]
    y = F.conv2d(p.cast(same_pad(x, k, s)), p.cast(conv.weight), stride=s)
    if conv.bias is not None:
        y = y + conv.bias.to(p.dtype)[:, None, None]
    return y


class ResBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int, p: Prec):
        super().__init__()
        self.p = p
        self.conv0 = nn.Conv2d(in_features, features, 3, stride, bias=False)
        self.gn0 = GroupNorm(features)
        self.conv1 = nn.Conv2d(features, features, 3, 1, bias=False)
        self.gn1 = GroupNorm(features)
        self.has_proj = in_features != features or stride != 1
        if self.has_proj:
            self.proj = nn.Conv2d(in_features, features, 1, stride, bias=False)
            self.proj_gn = GroupNorm(features)

    def forward(self, x):
        y = F.relu(self.gn0(conv_same(self.conv0, x, self.p)))
        y = self.gn1(conv_same(self.conv1, y, self.p))
        r = x
        if self.has_proj:
            r = self.proj_gn(conv_same(self.proj, x, self.p))
        return F.relu(y + r)


class Backbone(nn.Module):
    """Images (B, H, W, 3) float → features (B, H/16, W/16, C_out)."""

    def __init__(self, arch: dict, p: Prec):
        super().__init__()
        self.p = p
        self.stem = nn.Conv2d(3, arch["stem_features"], 7, 2, bias=False)
        self.stem_gn = GroupNorm(arch["stem_features"])
        blocks = []
        cin = arch["stem_features"]
        for si, (n_blocks, feats) in enumerate(zip(arch["stage_sizes"], arch["stage_features"])):
            for bi in range(n_blocks):
                blocks.append(ResBlock(cin, feats, 2 if (bi == 0 and si > 0) else 1, p))
                cin = feats
        self.blocks = nn.ModuleList(blocks)
        self.out_features = cin

    def forward(self, x):
        x = x.to(self.p.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_gn(conv_same(self.stem, x, self.p)))
        x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 2, 3, 1)


def _bilinear_weights(starts, ends, size: int, pool: int):
    """1-D bilinear interpolation matrix for one ROI axis → (..., P, size)."""
    starts = starts.float()
    ends = ends.float()
    bin_w = (ends - starts) / pool
    ar = torch.arange(pool, dtype=torch.float32, device=starts.device)
    centers = starts[..., None] + (ar + 0.5) * bin_w[..., None]
    pos = torch.clamp(centers - 0.5, 0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=starts.device)
    return torch.clamp(1.0 - torch.abs(pos[..., :, None] - grid), min=0.0)


def roi_align(features, boxes, stride: int, pool: int, p: Prec):
    """Separable bilinear ROI align, batched over images: per ROI
    ``Wy · F · Wxᵀ`` as two contractions with operands in ``p`` (float32
    accumulation), the first one's result rounded to ``p`` before the second.
    features (G, H, W, C), boxes (G, R, 4) → (G, R, P, P, C) in features' dtype."""
    single = features.dim() == 3
    if single:
        features, boxes = features[None], boxes[None]
    G, H, W, C = features.shape
    b = boxes.float() / stride
    wy = p.cast(_bilinear_weights(b[..., 1], b[..., 3], H, pool)).float()
    wx = p.cast(_bilinear_weights(b[..., 0], b[..., 2], W, pool)).float()
    f = p.cast(features).float()
    pooled = p.cast(torch.einsum("grph,ghwc->grpwc", wy, f)).float()
    pooled = torch.einsum("grqw,grpwc->grpqc", wx, pooled)
    pooled = pooled.to(features.dtype)
    return pooled[0] if single else pooled


class _PooledDense(nn.Linear):
    """First head layer over the pooled (..., P, P, C) tensor, flattened in
    (p, q, c) order; operands in ``p``, float32 accumulation and bias, the
    result in ``p``'s type."""

    def __init__(self, in_features: int, out_features: int, p: Prec):
        super().__init__(in_features, out_features)
        self.p = p

    def forward(self, x):
        x = self.p.cast(x.flatten(-3)).float()
        return F.linear(x, self.p.cast(self.weight).float(), self.bias.float()).to(self.p.dtype)


class RCNNHead(nn.Module):
    """Pooled ROI features → class logits (..., K), deltas (..., K, 4)."""

    def __init__(self, in_features: int, num_classes: int, hidden: int, ph: Prec, po: Prec):
        super().__init__()
        self.num_classes = num_classes
        self.ph, self.po = ph, po
        self.fc0 = _PooledDense(in_features, hidden, ph)
        self.fc1 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, num_classes)
        self.bbox = nn.Linear(hidden, num_classes * 4)

    def forward(self, roi_feats):
        ph, po = self.ph, self.po
        x = F.relu(self.fc0(roi_feats))
        x = F.linear(ph.cast(x).float(), ph.cast(self.fc1.weight).float()).to(ph.dtype)
        x = F.relu(x + self.fc1.bias.to(ph.dtype))
        x = po.cast(x).float()
        scores = F.linear(x, po.cast(self.cls.weight).float(), self.cls.bias.float())
        deltas = F.linear(x, po.cast(self.bbox.weight).float(), self.bbox.bias.float())
        deltas = deltas.reshape(deltas.shape[:-1] + (self.num_classes, 4))
        return scores, deltas


class Detector(nn.Module):
    """Backbone + ROI align + head; ``arch`` is a configuration's ``detector``."""

    def __init__(self, arch: dict, prec: Precisions):
        super().__init__()
        self.arch = arch
        self.prec = prec
        self.backbone = Backbone(arch, prec.backbone)
        P = arch["roi_pool"]
        self.head = RCNNHead(P * P * self.backbone.out_features, arch["num_classes"],
                             arch["head_hidden"], prec.head_hidden, prec.head_out)

    def forward(self, images, rois):
        feats = self.backbone(images)
        pooled = roi_align(feats, rois, DET_STRIDE, self.arch["roi_pool"], self.prec.roi_align)
        return self.head(pooled)


def preprocess_images(images_u8, arch: dict):
    """uint8 BGR (B, H, W, 3) → float32, mean-subtracted."""
    mean = torch.tensor(arch["pixel_mean"], dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() - mean) * arch["pixel_scale"]


class TrackerNet(nn.Module):
    """Frames (B, H, W, 3) float → dense stride-4 features; ``arch`` is a
    configuration's ``tracker``."""

    def __init__(self, arch: dict, prec: Precisions):
        super().__init__()
        self.arch = arch
        self.prec = prec
        convs, gns = [], []
        cin = 3
        for i, feats in enumerate(arch["features"]):
            convs.append(nn.Conv2d(cin, feats, 3, 2 if i < 2 else 1, bias=False))
            gns.append(GroupNorm(feats))
            cin = feats
        self.convs = nn.ModuleList(convs)
        self.gns = nn.ModuleList(gns)
        self.out = nn.Conv2d(cin, arch["out_features"], 1)

    def forward(self, x):
        p = self.prec.tracker_features
        x = x.to(p.dtype).permute(0, 3, 1, 2)
        for conv, gn in zip(self.convs, self.gns):
            x = F.relu(gn(conv_same(conv, x, p)))
        x = conv_same(self.out, x, p)
        return x.permute(0, 2, 3, 1)


def tracker_stride(arch: dict) -> int:
    return 2 ** min(2, len(arch["features"]))


def search_pool(arch: dict) -> int:
    return int(round(arch["template_pool"] * arch["search_factor"]))


def extract_template(feat, box, arch: dict, prec: Precisions):
    """Anchor-box template features, L2-normalized: feat (..., h, w, C) with
    box (..., 4) → (..., P, P, C) float32."""
    lead = box.shape[:-1]
    f = feat.reshape((-1,) + feat.shape[-3:])
    b = box.reshape(f.shape[0], -1, 4)
    pooled = roi_align(f, b, tracker_stride(arch), arch["template_pool"],
                       prec.tracker_template).float()
    norm = torch.sqrt(torch.sum(pooled * pooled, dim=(-3, -2, -1), keepdim=True) + 1e-6)
    return (pooled / norm).reshape(lead + pooled.shape[-3:])


def search_window(box, factor: float):
    """Box → centered window scaled by ``factor``."""
    cx = 0.5 * (box[..., 0] + box[..., 2])
    cy = 0.5 * (box[..., 1] + box[..., 3])
    w = (box[..., 2] - box[..., 0]) * factor
    h = (box[..., 3] - box[..., 1]) * factor
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def correlate(template, search_feat, p: Prec):
    """Normalized cross-correlation of each lane's template over its window
    (a VALID grouped conv over the lanes, operands in ``p``, float32 out)."""
    lead = template.shape[:-3]
    P, C = template.shape[-3], template.shape[-1]
    Q = search_feat.shape[-3]
    s = search_feat.float().reshape((-1, Q, Q, C)).permute(0, 3, 1, 2)
    L = s.shape[0]
    k = template.float().reshape((L, P, P, C)).permute(0, 3, 1, 2)
    resp = F.conv2d(p.cast(s.reshape(1, L * C, Q, Q)), p.cast(k), groups=L)[0].float()
    ones = torch.ones((1, 1, P, P), dtype=torch.float32, device=s.device)
    sq = F.conv2d((s * s).sum(1, keepdim=True), ones)[:, 0]
    out = resp / torch.sqrt(sq + 1e-6)
    return out.reshape(lead + out.shape[-2:])


def soft_argmax_2d(resp, temperature: float = 50.0):
    """Response maps (..., H, W) → soft peak (py, px) and peak value."""
    H, W = resp.shape[-2:]
    w = torch.softmax(temperature * resp.reshape(resp.shape[:-2] + (H * W,)), dim=-1)
    w = w.reshape(resp.shape)
    ys = torch.arange(H, dtype=torch.float32, device=resp.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=resp.device)[None, :]
    py = torch.sum(w * ys, dim=(-2, -1))
    px = torch.sum(w * xs, dim=(-2, -1))
    peak = torch.amax(resp, dim=(-2, -1))
    return py, px, peak


def ncc_update(feat_t, box, template, arch: dict, prec: Precisions):
    """One NCC update per lane at one scale: feat_t (G, h, w, C), box
    (G, L, 4), template (G, L, P, P, C) → (new boxes (G, L, 4), peaks (G, L))."""
    Q = search_pool(arch)
    P = arch["template_pool"]
    R = Q - P + 1
    G, L = box.shape[:2]
    # the box rebuilt around its centre, as the port's one-scale search does
    cx = 0.5 * (box[..., 0] + box[..., 2])
    cy = 0.5 * (box[..., 1] + box[..., 3])
    w = (box[..., 2] - box[..., 0]) * 1.0
    h = (box[..., 3] - box[..., 1]) * 1.0
    box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    win = search_window(box, arch["search_factor"])
    sfeat = roi_align(feat_t, win, tracker_stride(arch), Q,
                      prec.tracker_search_pool).reshape(G, L, Q, Q, -1)
    resp = correlate(template, sfeat, prec.tracker_corr)
    py, px, peak = soft_argmax_2d(resp)
    wx = (win[..., 2] - win[..., 0]) / Q
    wy = (win[..., 3] - win[..., 1]) / Q
    dx = (px - (R - 1) / 2.0) * wx
    dy = (py - (R - 1) / 2.0) * wy
    return box + torch.stack([dx, dy, dx, dy], dim=-1), peak


def tracker_features(model: TrackerNet, frames_u8):
    """(B, H, W, 3) uint8 → (B, h, w, C) dense tracker features."""
    return model(frames_u8.float() / 255.0 - 0.5)
