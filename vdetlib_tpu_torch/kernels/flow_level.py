"""Block-matching flow level: the CUDA kernel A and its plain PyTorch version.

Counterpart of ``vdetlib_tpu/kernels/flow_pallas.py::flow_level_pallas`` (the
TPU kernel) and ``vdetlib_tpu/kernels/flow.py::_flow_level`` (its XLA form).
For every integer shift (dx, dy) in [-search, search]², the squared
difference between ``i1`` and the edge-clamped shifted ``i2`` is box-filtered
over a (2r+1)² window with zero padding; an online soft-argmin over the
shifts gives the sub-pixel flow (dx, dy) of each pixel.

:func:`flow_level` is the wrapper: a CPU tensor goes through the plain
version :func:`_flow_level`, a CUDA tensor through ``csrc/flow_level.cu``.
Both take bf16 inputs (the fast presets' reduced level) or float32 ones (the
accurate pyramid's levels) and compute in float32 throughout; the JAX XLA
path squares and box-sums the bf16 level in bf16, so the two agree to the
MGP box-shift tolerance (mean-flow-in-box, the only consumer), not bitwise.
"""

from __future__ import annotations

import functools

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


# the kernel's launch (csrc/flow_level.cu): tiles of 32 columns, one warp per
# dy (at most 32), the warps' partial states and both windows in shared memory
TILE_W = 32
MAX_SMEM = 232_448  # bytes of shared memory a block can use on Hopper
MAX_PAIRS = 65_535  # the grid's second dimension
# estimated time of a block, in rows of row sums: it computes th + 2r rows,
# emits th (a soft-argmin over its dx: ~0.75 of a row's work) and spends
# about 3 rows' time staging and merging; with these weights the plan picks
# the fastest tile height swept on an H100 at 32, 63, 95 and 255 pairs
EMIT_ROWS, FIXED_ROWS = 0.75, 3.0


def smem_bytes(tile_h: int, search: int, radius: int) -> int:
    """Dynamic shared memory of a block with ``tile_h`` output rows."""
    nw = min(2 * search + 1, 32)
    c1, r1 = TILE_W + 2 * radius, tile_h + 2 * radius
    return 16 * nw * tile_h * TILE_W + 4 * (r1 * c1 + (r1 + 2 * search) * (c1 + 2 * search))


@functools.lru_cache(maxsize=None)
def tile_rows(P: int, H: int, W: int, search: int, radius: int, sms: int) -> int:
    """Output rows of a block's tile: the fewest estimated waves of blocks on
    ``sms`` multiprocessors times a block's time, among the tiles whose
    shared memory fits; raises if not even one row fits."""
    n_cols = -(-W // TILE_W)
    best = None
    for th in range(1, H + 1):
        if smem_bytes(th, search, radius) > MAX_SMEM:
            break
        waves = -(-P * n_cols * -(-H // th) // sms)
        cost = waves * (th + 2 * radius + EMIT_ROWS * th + FIXED_ROWS)
        if best is None or cost < best[0]:
            best = (cost, th)
    if best is None:
        raise ValueError(f"flow_level kernel: search {search}, radius {radius} exceed the "
                         f"shared memory of a block")
    return best[1]


def flow_level(i1, i2, search: int = 5, radius: int = 3, temperature: float = 0.08):
    """Batched flow level: (P, H, W) bf16 or float32 pairs → (P, H, W, 2) float32 flow.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``flow_level.launches`` counts the launches) or raise. The kernel takes
    any width (it tiles the columns), 1 <= P <= 65535, H * W < 2^31, and
    any search >= 0 and radius >= 0 whose windows fit a block's shared memory."""
    if i1.device.type == "cpu" and i2.device.type == "cpu":
        return _flow_level(i1, i2, search, radius, temperature)
    if i1.device.type != "cuda" or i2.device != i1.device:
        raise ValueError(f"flow_level: tensors on {i1.device} and {i2.device}")
    if i1.dtype not in (torch.bfloat16, torch.float32) or i2.dtype != i1.dtype:
        raise TypeError(f"flow_level kernel takes two bf16 or two float32 arrays, got "
                        f"{i1.dtype}, {i2.dtype}")
    if i1.dim() != 3 or i1.shape != i2.shape:
        raise ValueError(f"flow_level takes two (P, H, W) arrays, got {i1.shape}, {i2.shape}")
    if not (i1.is_contiguous() and i2.is_contiguous()):
        raise ValueError("flow_level kernel takes contiguous inputs")
    P, H, W = i1.shape
    if min(P, H, W) < 1 or P > MAX_PAIRS or H * W >= 2**31:
        raise ValueError(f"flow_level kernel takes 1 <= P <= {MAX_PAIRS} and H * W < 2^31, "
                         f"got {tuple(i1.shape)}")
    if search < 0 or radius < 0:
        raise ValueError(f"flow_level kernel: search {search}, radius {radius} must be >= 0")
    tile_h = tile_rows(P, H, W, search, radius, build.sm_count(i1.device.index))
    out = torch.empty((P, H, W, 2), dtype=torch.float32, device=i1.device)
    fn = build.load("flow_level")
    rc = fn(
        i1.data_ptr(), i2.data_ptr(), out.data_ptr(), int(i1.dtype == torch.float32), P, H, W,
        tile_h, search, radius, float(temperature),
        torch.cuda.current_stream(i1.device).cuda_stream,
    )
    build.check_launch("flow_level", rc)
    flow_level.launches += 1
    return out


flow_level.launches = 0
