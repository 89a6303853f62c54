"""Block-matching optical flow in plain PyTorch (a frozen copy of the port's
plain ``_flow_level`` and the reduced presets of ``flow_video``; no upsampling,
as the engines call it), and the MGP box shift.

For every integer shift in [-search, search]², the squared difference of
``i1`` and the edge-clamped shifted ``i2`` is box-filtered over a (2r+1)²
window with zero padding; an online soft-argmin over the shifts gives the
sub-pixel flow of each pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import Prec

def _box_mean(x, radius: int):
    """Windowed mean of (..., H, W) over a (2r+1)² box, zero padding, same size.

    Separable: a horizontal then a vertical window sum (``"SAME"``
    reduce_window semantics), divided by (2r+1)²."""
    k = 2 * radius + 1
    H, W = x.shape[-2:]
    xp = F.pad(x, (radius, radius))
    row = xp[..., 0:W]
    for o in range(1, k):
        row = row + xp[..., o : o + W]
    rp = F.pad(row, (0, 0, radius, radius))
    col = rp[..., 0:H, :]
    for o in range(1, k):
        col = col + rp[..., o : o + H, :]
    return col / float(k * k)


def _flow_level(i1, i2, search: int = 5, radius: int = 3, temperature: float = 0.08):
    """Plain block-matching flow for (..., H, W) image pairs → (..., H, W, 2).

    float32 arithmetic from any input dtype; the same online soft-argmin as
    the kernel (and the JAX ``_flow_level``), vectorised over pairs."""
    a = i1.float()
    b = i2.float()
    H, W = a.shape[-2:]
    S = 2 * search + 1
    dev = a.device
    rows = torch.arange(-search, H + search, device=dev).clamp(0, H - 1)
    cols = torch.arange(-search, W + search, device=dev).clamp(0, W - 1)
    b_pad = b.index_select(-2, rows).index_select(-1, cols)  # edge-replicated
    m = torch.full_like(a, float("inf"))
    den = torch.zeros_like(a)
    fx = torch.zeros_like(a)
    fy = torch.zeros_like(a)
    for i in range(S * S):
        dy = i // S - search
        dx = i % S - search
        shifted = b_pad[..., search + dy : search + dy + H, search + dx : search + dx + W]
        diff = a - shifted
        c = _box_mean(diff * diff, radius)
        m_new = torch.minimum(m, c)
        rescale = torch.exp(-temperature * (m - m_new))
        w = torch.exp(-temperature * (c - m_new))
        den = den * rescale + w
        fx = fx * rescale + w * float(dx)
        fy = fy * rescale + w * float(dy)
        m = m_new
    return torch.stack([fx / den, fy / den], dim=-1)


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


def flow_video(frames_u8, p: Prec, preset: str = "fastest", radius: int = 3,
               temperature: float = 0.08):
    """Flow of the reduced-resolution presets for all consecutive pairs of
    (T, H, W, 3) frames → (T-1, h, w, 2) on the preset's grid, values in
    full-resolution pixels: one block-matching level (±5 cells) on the gray
    frames pooled to the preset's resolution and rounded to ``p``."""
    if preset not in ("fast", "fastest"):
        raise ValueError(f"the reference runs the reduced presets only, not {preset!r}")
    pool = FLOW_PRESET_POOL[preset]
    gray = _avg_pool2(to_gray(frames_u8))
    if pool == 4:
        gray = _avg_pool2(gray)
    gray = p.cast(gray)
    if gray.shape[0] < 2:
        return torch.zeros((0, *gray.shape[1:], 2), dtype=torch.float32,
                           device=frames_u8.device)
    f = _flow_level(gray[:-1].contiguous(), gray[1:].contiguous(), search=5, radius=radius,
                    temperature=temperature)
    return f * float(pool)


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
