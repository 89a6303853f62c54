"""Greedy NMS on tensors — counterpart of ``vdetlib_tpu/kernels/nms.py``.

Semantics contract (shared with the JAX package and the numpy oracle in
``tests/oracle/nms.py``): visit boxes by (score desc, index asc); suppress
when IoU with any kept box is strictly greater than ``thresh``. The plain
fixpoint and the CUDA kernel B live in :mod:`.nms_grouped`, kernel C in
:mod:`.nms_batched`, kernel D in :mod:`.nms_sorted`.
"""

from __future__ import annotations

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET
from vdetlib_tpu_torch.kernels.nms_batched import MAX_SLOTS as BATCHED_MAX
from vdetlib_tpu_torch.kernels.nms_batched import nms_batched_kernel
from vdetlib_tpu_torch.kernels.nms_grouped import MAX_SLOTS as GROUPED_MAX
from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel, nms_unsorted_fixpoint
from vdetlib_tpu_torch.kernels.nms_sorted import nms_sorted_kernel

__all__ = ["batched_nms", "nms_grouped", "nms_host", "nms_unsorted_fixpoint"]


def batched_nms(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """NMS over a batch of independent problems.

    boxes (..., N, 4), scores/valid (..., N) → keep (..., N) bool. CPU tensors
    take the plain sort-free fixpoint. On a card, N <= 128 launches kernel C
    (as the JAX package runs its Pallas ``nms_pallas_fixpoint`` there),
    128 < N <= 512 launches kernel B with one group for every slot (the
    stream's MGP dedup at N = 3R = 192), and larger N launch kernel D, up to
    its ``MAX_SLOTS`` (8192; above, D's wrapper raises). Each computes the
    same exact keep set as the XLA fixpoint the JAX package runs above 128.
    """
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    if all(t.device.type == "cpu" for t in (boxes, scores, valid)):
        return nms_unsorted_fixpoint(boxes, scores, valid, thresh, offset)
    b = boxes.reshape(-1, n, 4).float().contiguous()
    s = scores.reshape(-1, n).float().contiguous()
    v = valid.reshape(-1, n).bool().contiguous()
    if n <= BATCHED_MAX:
        keep = nms_batched_kernel(b, s, v, thresh, offset)
    elif n <= GROUPED_MAX:
        g = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
        keep = nms_grouped_kernel(b, s, v, g, thresh, offset)
    else:
        keep = nms_sorted_kernel(b, s, v, thresh, offset)
    return keep.reshape(lead + (n,))


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


def nms_host(dets, thresh: float, offset: float = LEGACY_OFFSET) -> list[int]:
    """Host-side greedy NMS on dets[N, 5] = (x1, y1, x2, y2, score) → ranked
    keep indices (original numbering), in numpy.

    The JAX package's ``nms_host`` calls its native C++ library when built,
    else this same numpy greedy (``vdetlib_tpu/native::_nms_numpy``); the
    port does not build that library and keeps the numpy form.
    """
    dets = np.ascontiguousarray(dets, dtype=np.float32).reshape(-1, 5)
    if dets.shape[0] == 0:
        return []
    x1, y1, x2, y2, scores = dets.T.astype(np.float64)
    areas = (x2 - x1 + offset) * (y2 - y1 + offset)
    # stable sort on -score keeps index-ascending tie order
    order = np.argsort(-scores, kind="stable")
    keep: list[int] = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        ix1 = np.maximum(x1[i], x1[rest])
        iy1 = np.maximum(y1[i], y1[rest])
        ix2 = np.minimum(x2[i], x2[rest])
        iy2 = np.minimum(y2[i], y2[rest])
        iw = np.maximum(ix2 - ix1 + offset, 0.0)
        ih = np.maximum(iy2 - iy1 + offset, 0.0)
        inter = iw * ih
        union = areas[i] + areas[rest] - inter
        iou = np.where(union > 0, inter / union, 0.0)
        order = rest[iou <= thresh]
    return keep
