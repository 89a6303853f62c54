"""Dense optical flow on tensors — counterpart of ``vdetlib_tpu/kernels/flow.py``.

MGP consumes only the MEAN flow inside each detection box, so the
acceptance criterion is box-shift tolerance, not flow-field equality. The
``fast``/``fastest`` presets run one reduced-resolution block-matching level
(half / quarter resolution) through :func:`.flow_level.flow_level` — the CUDA
kernel A on a card. The ``accurate`` pyramid is not ported yet (ROADMAP.md,
Queue 1). The JAX package's ``VDETLIB_TPU_FLOW_UNROLL`` is a TPU compile knob
and has no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vdetlib_tpu_torch.kernels.flow_level import _box_mean, _flow_level, flow_level

__all__ = [
    "FLOW_PRESET_POOL", "_avg_pool2", "_box_mean", "_flow_level", "flow_coord_scale",
    "flow_video", "mean_flow_in_boxes", "to_gray",
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


def flow_video(frames_u8, levels: int = 3, search: int = 3, radius: int = 3,
               temperature: float = 0.08, preset: str = "accurate", upsample: bool = True):
    """Flow for all consecutive pairs of (T, H, W, 3) frames → (T-1, h, w, 2).

    Same signature as the JAX ``flow_video``. The reduced-resolution presets
    search ±5 cells at their own resolution (``levels``/``search`` belong to
    the pyramid and are ignored, as in the JAX package).

    flow[t] maps frame t → t+1. Values are in FULL-resolution pixels; with
    ``upsample=False`` the grid stays at the preset's resolution (consumers
    scale box coordinates by :func:`flow_coord_scale`), with ``upsample=True``
    it is resized bilinearly to (H, W). A video of fewer than two frames
    has no pair: the field is empty, ``(0, h, w, 2)`` float32 on the frames'
    device, as in the JAX package, and no level runs.
    """
    if preset not in ("fast", "fastest"):
        raise NotImplementedError(
            f"flow preset {preset!r}: the pyramid ('accurate') is not ported yet "
            "(ROADMAP.md, Queue 1)"
        )
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
