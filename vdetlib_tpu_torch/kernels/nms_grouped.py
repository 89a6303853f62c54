"""Grouped greedy NMS: the CUDA kernel B and its plain PyTorch version.

Counterpart of ``vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_grouped`` (the
TPU kernel) and ``vdetlib_tpu/kernels/nms.py::nms_unsorted_fixpoint`` (its
XLA form). Keep sets are exact: the same IoU op order, strict ``>``, and
precedence (score desc, then index asc) as the JAX package and the numpy
oracle in ``tests/oracle/nms.py``.

:func:`nms_grouped_kernel` is the wrapper: CPU tensors go through the plain
:func:`nms_unsorted_fixpoint`, CUDA tensors through ``csrc/nms_grouped.cu``.
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET, pairwise_iou
from vdetlib_tpu_torch.kernels import build

MAX_SLOTS = 512  # one thread per slot, adjacency rows of <= 16 words in registers


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


def nms_grouped_kernel(boxes, scores, valid, groups, thresh: float,
                       offset: float = LEGACY_OFFSET):
    """Grouped NMS over (B, N) problems → keep (B, N) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``nms_grouped_kernel.launches`` counts the launches) or raise."""
    tensors = (boxes, scores, valid, groups)
    if all(t.device.type == "cpu" for t in tensors):
        return nms_unsorted_fixpoint(boxes, scores, valid, thresh, offset, groups)
    dev = boxes.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"nms_grouped: tensors on {[str(t.device) for t in tensors]}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_grouped boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    B, N = boxes.shape[:2]
    if any(t.shape != (B, N) for t in (scores, valid, groups)):
        raise ValueError("nms_grouped scores/valid/groups must be (B, N) like boxes")
    dtypes = (boxes.dtype, scores.dtype, valid.dtype, groups.dtype)
    if dtypes != (torch.float32, torch.float32, torch.bool, torch.int32):
        raise TypeError(f"nms_grouped kernel takes (f32, f32, bool, int32), got {dtypes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nms_grouped kernel takes contiguous inputs")
    if not 1 <= N <= MAX_SLOTS or B < 1:
        raise ValueError(f"nms_grouped kernel takes 1 <= N <= {MAX_SLOTS}, got {N}")
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    fn = build.load("nms_grouped")
    rc = fn(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), groups.data_ptr(),
        keep.data_ptr(), B, N, float(thresh), float(offset),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch("nms_grouped", rc)
    nms_grouped_kernel.launches += 1
    return keep


nms_grouped_kernel.launches = 0
