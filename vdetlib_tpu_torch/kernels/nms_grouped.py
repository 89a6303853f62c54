"""Grouped greedy NMS: the CUDA kernel B and its plain PyTorch version.

Counterpart of ``vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_grouped`` (the
TPU kernel) and ``vdetlib_tpu/kernels/nms.py::nms_unsorted_fixpoint`` (its
XLA form). Keep sets are exact: the same IoU op order, strict ``>``, and
precedence (score desc, then index asc) as the JAX package and the numpy
oracle in ``tests/oracle/nms.py``.

:func:`nms_grouped_kernel` is the wrapper: CPU tensors go through the plain
:func:`nms_unsorted_fixpoint`, CUDA tensors through ``csrc/nms_grouped.cu``.
The wrapper owns the kernel's launch plan: the threads of a block
(:func:`launch_threads`) and its shared memory (:func:`smem_bytes`).
"""

from __future__ import annotations

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET, box_area, pairwise_iou
from vdetlib_tpu_torch.kernels import build

MAX_SLOTS = 512  # a block a problem, at least a thread a slot
MAX_THREADS = 1024
THREADS_PER_SM = 1024  # what the plan hands out: a block of 1024 runs at <= 64 registers


def launch_threads(B: int, N: int, sms: int) -> int:
    """Block size of kernels B and C for B problems of N slots on ``sms``
    SMs: at least a thread a slot (a multiple of 32, for the Jacobi steps);
    beyond that as many warps as spread ``THREADS_PER_SM`` threads over each
    SM, but no more than the adjacency has tiles (32 rows × 32 columns, on
    and above the diagonal) and at most 1024. A few problems take wide
    blocks, many take a thread a slot."""
    nw = -(-N // 32)
    least = 32 * nw
    tiles = 32 * nw * (nw + 1) // 2
    share = THREADS_PER_SM * sms // B // 32 * 32
    return min(MAX_THREADS, max(least, min(share, tiles)))


def smem_bytes(N: int) -> int:
    """A block's dynamic shared memory (mirrors ``nms_common.cuh::
    vdet_nms_smem_bytes``): per slot its box, area, score, group, index,
    valid-order group and rank, a keep byte, and its adjacency row of
    ⌈N/32⌉ words."""
    return N * (16 + 6 * 4) + N * -(-N // 32) * 4 + N


def iou_exceeds(a, b, thresh: float, offset: float = LEGACY_OFFSET):
    """``pairwise_iou(a, b) > thresh`` decided as kernels B and C decide it
    (``nms_common.cuh::vdet_iou_above_rn``), in float32: a zero
    intersection gives ``0 > thresh``; within the filter's ranges a pair
    whose intersection lies above ``RN(t_hi · union)`` or below
    ``RN(t_lo · union)`` is decided without the division; the rest divide.
    a (..., N, 4), b (..., M, 4) float32 → (..., N, M) bool."""
    t = float(np.float32(thresh))
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (ix2 - ix1 + offset).clamp(min=0.0) * (iy2 - iy1 + offset).clamp(min=0.0)
    uni = (box_area(a, offset)[..., :, None] + box_area(b, offset)[..., None, :]) - inter
    t32 = torch.tensor(t, dtype=torch.float32)
    hi = (t32 * (1 + 2.0**-20)) * uni
    lo = (t32 * (1 - 2.0**-20)) * uni
    zero = inter == 0
    in_range = (2.0**-60 <= t <= 2.0**60) & (uni >= 2.0**-60) & (uni <= 2.0**60)
    sure = zero | (in_range & ((inter > hi) | (inter < lo)))
    decided = torch.where(zero, torch.tensor(0.0 > t), inter > hi)
    return torch.where(sure, decided, pairwise_iou(a, b, offset=offset) > t)


def nms_unsorted_fixpoint(boxes, scores, valid, thresh: float,
                          offset: float = LEGACY_OFFSET, groups=None):
    """Sort-free greedy NMS by Jacobi fixpoint (plain version of kernel B).

    ``M[i, j] = IoU(i, j) > thresh ∧ j ≻ i ∧ valid_j`` (∧ same group), with
    ``j ≻ i ⇔ s_j > s_i ∨ (s_j = s_i ∧ j < i)`` on scores masked to -inf;
    the greedy keep set is the unique fixpoint of ``keep = valid ∧ ¬(M·keep)``.
    Iterates to that fixpoint (at most N steps) with one convergence check on
    the host per step — this version serves the CPU tests and the kernel's
    comparison on the card, not the main path.

    boxes (..., N, 4), scores/valid (..., N), groups (..., N) int → keep (..., N) bool.
    """
    n = boxes.shape[-2]
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    idx = torch.arange(n, device=boxes.device)
    prec = (s[..., None, :] > s[..., :, None]) | (
        (s[..., None, :] == s[..., :, None]) & (idx[None, :] < idx[:, None])
    )  # prec[i, j] ⇔ j visits before i
    m = (pairwise_iou(boxes, boxes, offset=offset) > thresh) & prec & valid[..., None, :]
    if groups is not None:
        m = m & (groups[..., None, :] == groups[..., :, None])
    keep = valid.clone()
    for _ in range(n):
        new = valid & ~(m & keep[..., None, :]).any(-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def check_nms_inputs(name: str, max_slots: int, boxes, scores, valid, groups=None):
    """The NMS kernels' contract: boxes (B, N, 4) f32, scores (B, N) f32,
    valid (B, N) bool (and groups (B, N) int32), all contiguous on one CUDA
    device, boxes 16-byte aligned, B >= 1 and 1 <= N <= ``max_slots``;
    raises otherwise. Returns (B, N)."""
    tensors = (boxes, scores, valid) + (() if groups is None else (groups,))
    dev = boxes.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{name} boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    B, N = boxes.shape[:2]
    if any(t.shape != (B, N) for t in tensors[1:]):
        raise ValueError(f"{name} scores/valid/groups must be (B, N) like boxes")
    dtypes = tuple(t.dtype for t in tensors)
    if dtypes != (torch.float32, torch.float32, torch.bool, torch.int32)[: len(tensors)]:
        raise TypeError(f"{name} kernel takes (f32, f32, bool[, int32]), got {dtypes}")
    if not all(t.is_contiguous() for t in tensors) or boxes.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes contiguous inputs, boxes 16-byte aligned")
    check_slots(name, max_slots, B, N)
    return B, N


def check_slots(name: str, max_slots: int, B: int, N: int) -> None:
    """The NMS kernels' size limit, run by :func:`check_nms_inputs`: raises
    unless B >= 1 and 1 <= N <= ``max_slots``."""
    if not 1 <= N <= max_slots or B < 1:
        raise ValueError(f"{name} kernel takes B >= 1 and 1 <= N <= {max_slots}, got ({B}, {N})")


def nms_grouped_kernel(boxes, scores, valid, groups, thresh: float,
                       offset: float = LEGACY_OFFSET):
    """Grouped NMS over (B, N) problems → keep (B, N) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``nms_grouped_kernel.launches`` counts the launches) or raise."""
    if all(t.device.type == "cpu" for t in (boxes, scores, valid, groups)):
        return nms_unsorted_fixpoint(boxes, scores, valid, thresh, offset, groups)
    B, N = check_nms_inputs("nms_grouped", MAX_SLOTS, boxes, scores, valid, groups)
    dev = boxes.device
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    fn = build.load("nms_grouped")
    rc = fn(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), groups.data_ptr(),
        keep.data_ptr(), B, N, launch_threads(B, N, build.sm_count(dev.index)), float(thresh),
        float(offset), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch("nms_grouped", rc)
    nms_grouped_kernel.launches += 1
    return keep


nms_grouped_kernel.launches = 0
