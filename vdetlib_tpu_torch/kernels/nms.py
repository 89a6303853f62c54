"""Greedy NMS on tensors — counterpart of ``vdetlib_tpu/kernels/nms.py``.

Semantics contract (shared with the JAX package and the numpy oracle in
``tests/oracle/nms.py``): visit boxes by (score desc, index asc); suppress
when IoU with any kept box is strictly greater than ``thresh``. The plain
fixpoint and the CUDA kernel B live in :mod:`.nms_grouped`, kernel C in
:mod:`.nms_batched`, kernel D in :mod:`.nms_sorted`. :func:`nms_xla` and
:func:`nms_fixpoint` are the JAX package's XLA forms (no Pallas kernel
computes them there), in plain PyTorch. :func:`nms_host` runs the native
host library ``csrc/nms_host.cpp``.
"""

from __future__ import annotations

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET, pairwise_iou
from vdetlib_tpu_torch.kernels import build
from vdetlib_tpu_torch.kernels.nms_batched import MAX_SLOTS as BATCHED_MAX
from vdetlib_tpu_torch.kernels.nms_batched import nms_batched_kernel
from vdetlib_tpu_torch.kernels.nms_grouped import MAX_SLOTS as GROUPED_MAX
from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel, nms_unsorted_fixpoint
from vdetlib_tpu_torch.kernels.nms_sorted import MAX_SLOTS as SORTED_MAX
from vdetlib_tpu_torch.kernels.nms_sorted import nms_sorted_kernel, visit_order

__all__ = ["batched_nms", "batched_route", "fixpoint_passes", "grouped_route", "nms_fixpoint",
           "nms_grouped", "nms_host", "nms_host_plain", "nms_unsorted_fixpoint", "nms_xla",
           "sort_by_score"]

# the Jacobi steps between two convergence checks of nms_fixpoint (each
# check reads a flag back to the host)
FIXPOINT_CHECK_EVERY = 8
# a fixpoint pass builds the (problems, N, N) adjacency of at most this many
# entries (512 MiB in float32; the pairwise IoU's intermediates of the same
# shape take several times that at the pass's peak)
FIXPOINT_ELEMS = 1 << 27


def fixpoint_passes(fn, boxes, scores, valid, *rest, max_elems: int = FIXPOINT_ELEMS):
    """``fn(boxes, scores, valid, *rest)`` over (B, N) problems, in passes of
    at most ``max_elems`` adjacency entries (at least one problem a pass)
    → keep (B, N) bool."""
    n, B = scores.shape[-1], scores.shape[0]
    step = max(1, max_elems // (n * n))
    return torch.cat([fn(boxes[i:i + step], scores[i:i + step], valid[i:i + step],
                         *(r[i:i + step] for r in rest)) for i in range(0, max(B, 1), step)])


def grouped_route(n: int) -> str:
    """Where :func:`nms_grouped` sends problems of ``n`` slots on a card, as
    the JAX ``nms_grouped`` routes them: ``"kernel"`` (B) up to its 512 slots
    (JAX runs its Pallas kernel for n <= 512), ``"fixpoint"`` above
    (``nms_unsorted_fixpoint`` with groups in torch ops, as JAX runs its XLA
    fixpoint there)."""
    return "kernel" if n <= GROUPED_MAX else "fixpoint"


def batched_route(n: int) -> str:
    """Where :func:`batched_nms` sends problems of ``n`` slots on a card:
    ``"batched"`` (C) up to 128 slots, ``"grouped"`` (B with one group) up to
    512, ``"sorted"`` (D) up to its ``MAX_SLOTS`` (8,192: a block's shared
    memory), ``"fixpoint"`` above (``nms_unsorted_fixpoint`` in torch ops, the
    XLA fixpoint the JAX package runs for every N > 128)."""
    if n <= BATCHED_MAX:
        return "batched"
    if n <= GROUPED_MAX:
        return "grouped"
    return "sorted" if n <= SORTED_MAX else "fixpoint"


def sort_by_score(scores, valid):
    """Visit order: valid first, score desc, original index asc → (..., N)
    int64 (``jnp.argsort(-masked, stable=True)``: -0.0 ties +0.0, NaN after
    every number)."""
    return visit_order(scores, valid)


def nms_xla(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """Greedy NMS over one padded problem, the masked-greedy loop of N steps.

    boxes (N, 4), scores/valid (N,) → (keep (N,) bool in input order,
    order (N,) the visit order)."""
    n = boxes.shape[0]
    order = sort_by_score(scores, valid)
    sboxes = boxes[order]
    suppress = pairwise_iou(sboxes, sboxes, offset=offset) > thresh
    later = torch.arange(n, device=boxes.device)
    keep = valid[order]
    for i in range(n):  # a kept box knocks out every later box it overlaps too much
        keep = torch.where(keep[i], keep & ~(suppress[i] & (later > i)), keep)
    return torch.zeros_like(keep).scatter(0, order, keep), order


def nms_fixpoint(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """Greedy NMS as a Jacobi fixpoint — the JAX package's MXU form.

    In visit order, ``keep[i] = valid[i] ∧ ¬∃ j<i: M[i,j] ∧ keep[j]`` (M =
    IoU > thresh) has one solution, the greedy keep set; the iteration
    ``keep ← valid ∧ ¬(M·keep > 0)`` reaches it in as many steps as the
    suppression chains are deep, each step one batched matrix-vector
    product. JAX stops when a step changes nothing (or after N steps); this
    checks every ``FIXPOINT_CHECK_EVERY`` steps, capped at N, which gives
    the same keep set: a converged fixpoint stays.

    boxes (..., N, 4), scores/valid (..., N) → keep (..., N) bool in input
    order.
    """
    n = boxes.shape[-2]
    order = sort_by_score(scores, valid)
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    svalid = torch.take_along_dim(valid, order, dim=-1)
    idx = torch.arange(n, device=boxes.device)
    lower = idx[:, None] > idx[None, :]  # row i is suppressed by an earlier column j
    m = ((pairwise_iou(sboxes, sboxes, offset=offset) > thresh) & lower
         & svalid[..., None, :]).float()
    svalid_f = svalid.float()
    keep, steps = svalid_f, 0
    while steps < n:
        for _ in range(min(FIXPOINT_CHECK_EVERY, n - steps)):
            prev = keep
            suppressed = torch.matmul(m, keep[..., None])[..., 0] > 0.5
            keep = svalid_f * (1.0 - suppressed.float())
            steps += 1
        if torch.equal(keep, prev):
            break
    return torch.zeros_like(svalid).scatter(-1, order, keep > 0.5)


def batched_nms(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """NMS over a batch of independent problems.

    boxes (..., N, 4), scores/valid (..., N) → keep (..., N) bool. CPU tensors
    take the plain sort-free fixpoint. On a card :func:`batched_route`
    decides: N <= 128 launches kernel C (as the JAX package runs its Pallas
    ``nms_pallas_fixpoint`` there), 128 < N <= 512 launches kernel B with one
    group for every slot (the stream's MGP dedup at N = 3R = 192), N up to
    D's ``MAX_SLOTS`` launches kernel D, and above it the sort-free fixpoint
    runs in torch ops, in passes of at most ``FIXPOINT_ELEMS`` adjacency
    entries. Each computes the same exact keep set as the XLA fixpoint the
    JAX package runs above 128.
    """
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    if all(t.device.type == "cpu" for t in (boxes, scores, valid)):
        return nms_unsorted_fixpoint(boxes, scores, valid, thresh, offset)
    b = boxes.reshape(-1, n, 4).float().contiguous()
    s = scores.reshape(-1, n).float().contiguous()
    v = valid.reshape(-1, n).bool().contiguous()
    route = batched_route(n)
    if route == "batched":
        keep = nms_batched_kernel(b, s, v, thresh, offset)
    elif route == "grouped":
        g = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
        keep = nms_grouped_kernel(b, s, v, g, thresh, offset)
    elif route == "sorted":
        keep = nms_sorted_kernel(b, s, v, thresh, offset)
    else:
        keep = fixpoint_passes(lambda *a: nms_unsorted_fixpoint(*a, thresh, offset), b, s, v)
    return keep.reshape(lead + (n,))


def nms_grouped(boxes, scores, valid, groups, thresh: float, offset: float = LEGACY_OFFSET):
    """Greedy NMS of disjoint group sub-problems sharing one slot axis.

    Equivalent to per-group NMS (per-class NMS when each slot carries one
    class, as in the fused pipeline) with one (N, N) IoU for all groups:
    the plain version on the CPU; on a card :func:`grouped_route` decides,
    kernel B up to 512 slots, the sort-free fixpoint with groups in torch
    ops above (the fused dedup at ``mgp_window`` >= 4 has 64 × 9 = 576 slots
    and more), in passes of at most ``FIXPOINT_ELEMS`` adjacency entries.

    boxes (..., N, 4), scores/valid/groups (..., N) → keep (..., N) bool.
    """
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    args = (boxes.reshape(-1, n, 4).float().contiguous(),
            scores.reshape(-1, n).float().contiguous(),
            valid.reshape(-1, n).bool().contiguous(),
            groups.reshape(-1, n).to(torch.int32).contiguous())
    if args[0].device.type == "cuda" and grouped_route(n) == "fixpoint":
        keep = fixpoint_passes(
            lambda b, s, v, g: nms_unsorted_fixpoint(b, s, v, thresh, offset, groups=g), *args)
    else:
        keep = nms_grouped_kernel(*args, thresh, offset)
    return keep.reshape(lead + (n,))


def nms_host(dets, thresh: float, offset: float = LEGACY_OFFSET) -> list[int]:
    """Host-side greedy NMS on dets[N, 5] = (x1, y1, x2, y2, score) → ranked
    keep indices (original numbering), in the native library
    ``csrc/nms_host.cpp`` (the JAX package's ``native/nms.cpp``), built with
    ``g++`` at first use. A failed build or load raises :class:`KernelError`;
    :func:`nms_host_plain` is the numpy version of the same greedy."""
    dets = np.ascontiguousarray(dets, dtype=np.float32).reshape(-1, 5)
    n = dets.shape[0]
    if n == 0:
        return []
    keep = np.empty(n, np.int32)
    n_keep = build.load("nms_host")(dets.ctypes.data, n, thresh, offset, keep.ctypes.data)
    return keep[:n_keep].tolist()


def nms_host_plain(dets, thresh: float, offset: float = LEGACY_OFFSET) -> list[int]:
    """:func:`nms_host` in numpy (``vdetlib_tpu/native::_nms_numpy``)."""
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
