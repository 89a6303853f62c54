"""Greedy per-group NMS in plain PyTorch: the sort-free Jacobi fixpoint (a
frozen copy of the port's ``nms_unsorted_fixpoint``), whose unique fixpoint
is the greedy keep set (score descending, index ascending on ties).
"""

from __future__ import annotations

import torch

from portbench.reference.boxes import LEGACY_OFFSET, pairwise_iou

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


def batched_nms(boxes, scores, valid, thresh: float):
    """Independent problems (..., N): keep (..., N) bool."""
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    keep = nms_unsorted_fixpoint(boxes.reshape(-1, n, 4).float(), scores.reshape(-1, n).float(),
                                 valid.reshape(-1, n).bool(), thresh)
    return keep.reshape(lead + (n,))


def nms_grouped(boxes, scores, valid, groups, thresh: float):
    """Disjoint groups (per-class NMS) sharing one slot axis: keep (..., N)."""
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    keep = nms_unsorted_fixpoint(boxes.reshape(-1, n, 4).float(), scores.reshape(-1, n).float(),
                                 valid.reshape(-1, n).bool(), thresh,
                                 groups=groups.reshape(-1, n).to(torch.int32))
    return keep.reshape(lead + (n,))
