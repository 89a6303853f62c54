"""Block-matching flow level: the CUDA kernel A and its plain PyTorch version.

Counterpart of ``vdetlib_tpu/kernels/flow_pallas.py::flow_level_pallas`` (the
TPU kernel) and ``vdetlib_tpu/kernels/flow.py::_flow_level`` (its XLA form).
For every integer shift (dx, dy) in [-search, search]², the squared
difference between ``i1`` and the edge-clamped shifted ``i2`` is box-filtered
over a (2r+1)² window with zero padding; an online soft-argmin over the
shifts gives the sub-pixel flow (dx, dy) of each pixel.

:func:`flow_level` is the wrapper: a CPU tensor goes through the plain
version :func:`_flow_level`, a CUDA tensor through ``csrc/flow_level.cu``.
Both take bf16 inputs and compute in float32 throughout; the JAX XLA path
squares and box-sums in bf16, so the two agree to the MGP box-shift
tolerance (mean-flow-in-box, the only consumer), not bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vdetlib_tpu_torch.kernels import build


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


def flow_level(i1, i2, search: int = 5, radius: int = 3, temperature: float = 0.08):
    """Batched flow level: (P, H, W) bf16 pairs → (P, H, W, 2) float32 flow.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``flow_level.launches`` counts the launches) or raise."""
    if i1.device.type == "cpu" and i2.device.type == "cpu":
        return _flow_level(i1, i2, search, radius, temperature)
    if i1.device.type != "cuda" or i2.device != i1.device:
        raise ValueError(f"flow_level: tensors on {i1.device} and {i2.device}")
    if i1.dtype != torch.bfloat16 or i2.dtype != torch.bfloat16:
        raise TypeError(f"flow_level kernel takes bf16, got {i1.dtype}, {i2.dtype}")
    if i1.dim() != 3 or i1.shape != i2.shape:
        raise ValueError(f"flow_level takes two (P, H, W) arrays, got {i1.shape}, {i2.shape}")
    if not (i1.is_contiguous() and i2.is_contiguous()):
        raise ValueError("flow_level kernel takes contiguous inputs")
    P, H, W = i1.shape
    if W > 1024 or min(P, H, W) < 1:
        raise ValueError(f"flow_level kernel takes 1 <= W <= 1024, got {tuple(i1.shape)}")
    out = torch.empty((P, H, W, 2), dtype=torch.float32, device=i1.device)
    tile_h = max(1, min(H, 1024 // W))
    fn = build.load("flow_level")
    rc = fn(
        i1.data_ptr(), i2.data_ptr(), out.data_ptr(), P, H, W, tile_h, search, radius,
        float(temperature), torch.cuda.current_stream(i1.device).cuda_stream,
    )
    build.check_launch("flow_level", rc)
    flow_level.launches += 1
    return out


flow_level.launches = 0
