"""Sorted greedy NMS: the CUDA kernel D and its plain PyTorch version.

Counterpart of ``vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_batch`` (the
TPU kernel): a stable sort by masked score (valid first, score desc, index
asc), the greedy keep/suppress walk in that order, and a scatter back to
input order. :func:`nms_sorted_greedy` is the plain version of the whole
function. Same keep set as every NMS of the package and the numpy oracle.

:func:`nms_sorted_kernel` is the wrapper: CPU tensors go through the plain
version, CUDA tensors through ``csrc/nms_sorted.cu``, which sorts, walks and
writes keep in input order in one launch. The wrapper owns the launch plan:
the threads of a block (:func:`launch_threads`) and its shared memory
(:func:`smem_bytes`), which bounds the slots a problem may hold
(``MAX_SLOTS``).
"""

from __future__ import annotations

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET, pairwise_iou
from vdetlib_tpu_torch.kernels import build
from vdetlib_tpu_torch.kernels.nms_grouped import check_nms_inputs

SMEM_OPTIN = 232_448  # an H100 block's shared memory after the opt-in (227 KB)
MAX_THREADS = 1024


def _pow2_at_least(n: int) -> int:
    p = 32
    while p < n:
        p *= 2
    return p


def smem_bytes(N: int) -> int:
    """A block's dynamic shared memory for N slots (mirrors
    ``nms_sorted.cu::vdet_nms_sorted_smem_bytes``): a 64-bit visit key for
    each of N rounded up to a power of two (>= 32) slots, a box and an area a
    slot in visit order, a suppressed bit a slot, and 66 words of warp
    counts and chunk keep masks."""
    return 8 * _pow2_at_least(N) + 20 * N + 4 * -(-N // 32) + 4 * 66


def _max_slots() -> int:
    lo, hi = 1, 1 << 16  # smem_bytes(lo) fits, smem_bytes(hi) does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if smem_bytes(mid) <= SMEM_OPTIN else (lo, mid)
    return lo


MAX_SLOTS = _max_slots()  # the most slots whose block fits SMEM_OPTIN (8192)


def launch_threads(N: int) -> int:
    """Block size of kernel D for problems of N slots: N rounded up to a
    power of two, quartered (the load takes 4 slots a thread in one pass, the
    sort's register stages 64 keys a warp twice over), at least a warp and
    at most 1024. A block's time is mostly latency, so small blocks let many
    problems share an SM: 128 threads at N = 512 put the frame-NMS tool's
    1,920 problems on the card at once. The threads stride over the slots,
    so N is not bound to them."""
    return min(MAX_THREADS, max(32, _pow2_at_least(N) // 4))


def visit_order(scores, valid):
    """(B, N) → the greedy visit order: valid first, score desc, index asc."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    return torch.sort(-masked, dim=-1, stable=True).indices


def visit_key(scores, index):
    """Kernel D's 64-bit visit key (``nms_sorted.cu::vdet_visit_key``) in
    numpy: the order-preserving bits of -score above the slot's index, with
    -0.0 as +0.0 and every NaN as 0xffffffff, so that the valid slots sorted
    by key ascending come in :func:`visit_order`'s order (torch.sort puts NaN
    after every number). scores float32 and index int, same shape → uint64."""
    v = -np.asarray(scores, dtype=np.float32)
    v = np.where(v == 0, np.float32(0.0), v).astype(np.float32)
    u = v.view(np.uint32)
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    u = np.where(np.isnan(v), np.uint32(0xFFFFFFFF), u).astype(np.uint64)
    return (u << np.uint64(32)) | np.asarray(index).astype(np.uint64)


def nms_sorted_greedy(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """Plain version of kernel D: boxes (B, N, 4), scores/valid (B, N) → keep (B, N).

    The N-step greedy walk runs over the whole batch at once; step i
    recomputes row i's IoU against every box (as the TPU kernel does), so the
    memory stays O(B·N)."""
    order = visit_order(scores, valid)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(boxes.shape))
    keep = torch.gather(valid, 1, order)
    n = boxes.shape[1]
    idx = torch.arange(n, device=boxes.device)
    for i in range(n):
        row = pairwise_iou(sboxes[:, i : i + 1], sboxes, offset=offset)[:, 0]  # (B, N)
        keep = keep & ~(keep[:, i : i + 1] & (row > thresh) & (idx > i))
    return torch.zeros_like(keep).scatter(-1, order, keep)


def nms_sorted_kernel(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """Greedy NMS of (B, N) problems, N <= ``MAX_SLOTS`` → keep (B, N) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    (``nms_sorted_kernel.launches`` counts the launches) or raise."""
    if all(t.device.type == "cpu" for t in (boxes, scores, valid)):
        return nms_sorted_greedy(boxes, scores, valid, thresh, offset)
    B, N = check_nms_inputs("nms_sorted", MAX_SLOTS, boxes, scores, valid)
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    fn = build.load("nms_sorted")
    rc = fn(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, N,
        launch_threads(N), float(thresh), float(offset),
        torch.cuda.current_stream(boxes.device).cuda_stream,
    )
    build.check_launch("nms_sorted", rc)
    nms_sorted_kernel.launches += 1
    return keep


nms_sorted_kernel.launches = 0
