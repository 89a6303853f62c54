"""Dense optical flow on tensors — counterpart of ``vdetlib_tpu/kernels/flow.py``.

MGP consumes only the MEAN flow inside each detection box, so the
acceptance criterion is box-shift tolerance, not flow-field equality. The
``fast``/``fastest`` presets run one reduced-resolution block-matching level
(half / quarter resolution, bf16) through :func:`.flow_level.flow_level` —
the CUDA kernel A on a card. The ``accurate`` preset is the coarse-to-fine
pyramid :func:`flow_pair` on float32 gray frames at full resolution: each of
its levels is one call of the same wrapper (kernel A's float32 path on a
card) for all pairs at once, with the bilinear upsampling and warping in
tensor ops between them. The JAX package's ``VDETLIB_TPU_FLOW_UNROLL`` is a
TPU compile knob and has no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vdetlib_tpu_torch.kernels.flow_level import _box_mean, _flow_level, flow_level

__all__ = [
    "FLOW_PRESET_POOL", "_avg_pool2", "_box_mean", "_flow_level", "_warp_bilinear",
    "flow_coord_scale", "flow_pair", "flow_video", "mean_flow_in_boxes", "to_gray",
]

# native pyramid pooling per preset: 1 = full res, 2 = half, 4 = quarter
FLOW_PRESET_POOL = {"accurate": 1, "fast": 2, "fastest": 4}


def to_gray(frames_u8):
    """(..., H, W, 3) BGR uint8 → (..., H, W) float32 luma (Rec.601)."""
    f = frames_u8.float()
    return f[..., 0] * 0.114 + f[..., 1] * 0.587 + f[..., 2] * 0.299


def flow_coord_scale(preset: str) -> float:
    """Box-coordinate scale onto the preset's native (no-upsample) flow grid."""
    return 1.0 / FLOW_PRESET_POOL[preset]


def _avg_pool2(x):
    """2x2 mean-pool of (..., H, W) (odd trailing row/column dropped)."""
    s = x.shape
    x = x[..., : s[-2] // 2 * 2, : s[-1] // 2 * 2]
    x = x.reshape(s[:-2] + (s[-2] // 2, 2, s[-1] // 2, 2))
    return x.mean(dim=(-3, -1))


def _warp_bilinear(img, flow):
    """Warp (..., H, W) by (..., H, W, 2) flow: sample ``img`` at (x, y) +
    flow, clamped to the image, bilinearly from the pixels at the floor and
    floor + 1 (clamped), in the JAX function's order of operations."""
    H, W = img.shape[-2:]
    dev = img.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + flow[..., 1]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + flow[..., 0]
    ys = torch.clamp(ys, 0.0, H - 1.0)
    xs = torch.clamp(xs, 0.0, W - 1.0)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = ys - y0
    wx = xs - x0
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(yy.shape[:-2] + (H * W,))
        return torch.gather(flat, -1, idx).reshape(yy.shape)

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    return v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx


def flow_pair(g1, g2, levels: int = 3, search: int = 3, radius: int = 3,
              temperature: float = 0.08):
    """Coarse-to-fine flow between (P, H, W) float32 gray pairs → (P, H, W, 2).

    The JAX ``flow_pair`` for all P pairs at once: ``levels`` levels of 2×2
    mean pools; the coarsest level is one block-matching level; each finer
    level takes the coarser flow ×2, resized bilinearly to its shape, warps
    ``g2``'s level by it and adds the block-matching flow of the residual.
    Each level is one :func:`.flow_level.flow_level` call (kernel A on a
    card), so a call launches ``levels`` kernels."""
    pyr1, pyr2 = [g1], [g2]
    for _ in range(levels - 1):
        pyr1.append(_avg_pool2(pyr1[-1]))
        pyr2.append(_avg_pool2(pyr2[-1]))
    flow = None
    for lvl in reversed(range(levels)):
        i1, i2 = pyr1[lvl].contiguous(), pyr2[lvl].contiguous()
        if flow is None:
            flow = flow_level(i1, i2, search=search, radius=radius, temperature=temperature)
        else:
            up = F.interpolate((flow * 2.0).permute(0, 3, 1, 2), size=i1.shape[-2:],
                               mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
            i2w = _warp_bilinear(i2, up).contiguous()
            res = flow_level(i1, i2w, search=search, radius=radius, temperature=temperature)
            flow = up + res
    return flow


def flow_video(frames_u8, levels: int = 3, search: int = 3, radius: int = 3,
               temperature: float = 0.08, preset: str = "accurate", upsample: bool = True):
    """Flow for all consecutive pairs of (T, H, W, 3) frames → (T-1, h, w, 2).

    Same signature as the JAX ``flow_video``. ``accurate`` runs the pyramid
    (:func:`flow_pair`) on float32 gray frames, honouring ``levels``,
    ``search`` and ``radius``, and returns full resolution whatever
    ``upsample`` says, as in the JAX package. The reduced-resolution presets
    search ±5 cells at their own resolution (``levels``/``search`` belong to
    the pyramid and are ignored, as in the JAX package).

    flow[t] maps frame t → t+1. Values are in FULL-resolution pixels; with
    ``upsample=False`` a reduced preset's grid stays at its resolution
    (consumers scale box coordinates by :func:`flow_coord_scale`), with
    ``upsample=True`` it is resized bilinearly to (H, W). A video of fewer
    than two frames has no pair: the field is empty, ``(0, h, w, 2)``
    float32 on the frames' device, as in the JAX package, and no level runs.
    """
    if preset not in FLOW_PRESET_POOL:
        raise ValueError(f"flow preset {preset!r}: one of {tuple(FLOW_PRESET_POOL)}")
    if preset == "accurate":
        gray = to_gray(frames_u8)
        if gray.shape[0] < 2:
            return torch.zeros((0, *gray.shape[1:], 2), dtype=torch.float32,
                               device=frames_u8.device)
        return flow_pair(gray[:-1], gray[1:], levels=levels, search=search, radius=radius,
                         temperature=temperature)
    pool = FLOW_PRESET_POOL[preset]
    gray = _avg_pool2(to_gray(frames_u8))
    if pool == 4:
        gray = _avg_pool2(gray)
    gray = gray.to(torch.bfloat16)
    if gray.shape[0] < 2:
        hw = gray.shape[1:] if not upsample else frames_u8.shape[1:3]
        return torch.zeros((0, *hw, 2), dtype=torch.float32, device=frames_u8.device)
    f = flow_level(
        gray[:-1].contiguous(), gray[1:].contiguous(),
        search=5, radius=radius, temperature=temperature,
    )
    f = f * float(pool)  # reduced-res displacements → full-res px
    if not upsample:
        return f
    full = frames_u8.shape[1:3]
    up = F.interpolate(f.permute(0, 3, 1, 2), size=full, mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def mean_flow_in_boxes(flow, boxes, valid):
    """Mean flow vector inside each box (the MGP shift), batched.

    Args:
      flow: (..., H, W, 2); boxes: (..., N, 4) pixel [x1,y1,x2,y2] on the flow
        grid; valid: (..., N) bool.
    Returns:
      (..., N, 2) mean (dx, dy) per box (zeros for invalid boxes).

    A 2-D integral image makes every box O(1).
    """
    H, W = flow.shape[-3:-1]
    lead = flow.shape[:-3]
    ii = torch.cumsum(torch.cumsum(flow, dim=-3), dim=-2)
    ii = F.pad(ii, (0, 0, 1, 0, 1, 0))  # (..., H+1, W+1, 2)
    x1 = torch.floor(boxes[..., 0]).long().clamp(0, W - 1)
    y1 = torch.floor(boxes[..., 1]).long().clamp(0, H - 1)
    x2 = torch.minimum(torch.maximum(torch.ceil(boxes[..., 2]).long() + 1, x1 + 1),
                       torch.full_like(x1, W))
    y2 = torch.minimum(torch.maximum(torch.ceil(boxes[..., 3]).long() + 1, y1 + 1),
                       torch.full_like(y1, H))
    flat = ii.reshape(lead + ((H + 1) * (W + 1), 2))

    def at(y, x):
        idx = (y * (W + 1) + x)[..., None].expand(y.shape + (2,))
        return torch.gather(flat, -2, idx)

    total = at(y2, x2) - at(y1, x2) - at(y2, x1) + at(y1, x1)
    area = ((y2 - y1) * (x2 - x1)).float()[..., None]
    mean = total / torch.clamp(area, min=1.0)
    return torch.where(valid[..., None], mean, torch.zeros_like(mean))
