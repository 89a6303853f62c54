"""Greedy NMS on tensors — counterpart of ``vdetlib_tpu/kernels/nms.py``.

Semantics contract (shared with the JAX package and the numpy oracle in
``tests/oracle/nms.py``): visit boxes by (score desc, index asc); suppress
when IoU with any kept box is strictly greater than ``thresh``. The plain
fixpoint and the CUDA kernel B live in :mod:`.nms_grouped`.
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET
from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel, nms_unsorted_fixpoint

__all__ = ["nms_grouped", "nms_unsorted_fixpoint"]


def nms_grouped(boxes, scores, valid, groups, thresh: float, offset: float = LEGACY_OFFSET):
    """Greedy NMS of disjoint group sub-problems sharing one slot axis.

    Equivalent to per-group NMS (per-class NMS when each slot carries one
    class, as in the fused pipeline) with one (N, N) IoU for all groups,
    through the kernel B wrapper: the plain version on the CPU, the CUDA
    kernel (up to 512 slots) on a card.

    boxes (..., N, 4), scores/valid/groups (..., N) → keep (..., N) bool.
    """
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    keep = nms_grouped_kernel(
        boxes.reshape(-1, n, 4).float().contiguous(),
        scores.reshape(-1, n).float().contiguous(),
        valid.reshape(-1, n).bool().contiguous(),
        groups.reshape(-1, n).to(torch.int32).contiguous(),
        thresh,
        offset,
    )
    return keep.reshape(lead + (n,))
