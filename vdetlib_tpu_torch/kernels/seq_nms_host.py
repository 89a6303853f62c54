"""Host (numpy) seq-NMS — the port's copy of ``vdetlib_tpu/kernels/seq_nms_host.py``.

The ``host`` backend of the link stage (``video/link.py``): the same
contract as ``kernels/seq_nms.py::seq_nms_batch`` and the numpy oracle in
``tests/oracle/seq_nms.py`` (path boxes get the path statistic, suppressed
boxes -1, leftovers keep their score), with the dense (N, N) adjacency per
frame pair and a Python loop over paths that stops when none is left.
"""

from __future__ import annotations

import numpy as np

from vdetlib_tpu_torch.utils.common import iou as iou_matrix

__all__ = ["seq_nms_batch_host", "seq_nms_single_host"]


def seq_nms_single_host(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                        max_paths: int = 100, rescore: str = "avg", offset: float = 1.0):
    """Seq-NMS over one class: boxes (T, N, 4), scores/mask (T, N) →
    out_scores (T, N) float32, path_id (T, N) int32 (-1 = none)."""
    T, N = scores.shape
    adj = np.zeros((max(T - 1, 0), N, N), bool)
    for t in range(T - 1):
        adj[t] = iou_matrix(boxes[t], boxes[t + 1], offset) > link_thresh

    alive = mask.copy()
    out_scores = np.where(mask, scores, 0.0).astype(np.float64)
    path_id = np.full((T, N), -1, np.int64)
    NEG = -1e30

    for p in range(max_paths):
        if not alive.any():
            break
        s = np.where(alive, scores, NEG)
        dp = np.full((T, N), NEG)
        bp = np.full((T, N), -1, np.int64)
        dp[0] = s[0]
        for t in range(1, T):
            cand = np.where(adj[t - 1], dp[t - 1][:, None], NEG)  # (N, N)
            prev_best = cand.max(axis=0)
            prev_arg = cand.argmax(axis=0)
            use_prev = prev_best > 0
            dp[t] = np.where(alive[t], s[t] + np.maximum(prev_best, 0.0), NEG)
            bp[t] = np.where(use_prev & alive[t], prev_arg, -1)
        flat = int(dp.argmax())
        t_star, i_star = divmod(flat, N)
        if dp[t_star, i_star] <= 0:
            break
        path = []
        t, i = t_star, i_star
        while i >= 0:
            path.append((t, int(i)))
            i = bp[t, i]
            t -= 1
        path.reverse()
        stat_scores = [scores[t, i] for t, i in path]
        stat = float(np.mean(stat_scores)) if rescore == "avg" else float(np.max(stat_scores))
        for t, i in path:
            out_scores[t, i] = stat
            path_id[t, i] = p
            alive[t, i] = False
        for t, i in path:
            row = iou_matrix(boxes[t, i:i + 1], boxes[t], offset)[0]
            kill = (row > suppress_thresh) & alive[t]
            out_scores[t][kill] = -1.0
            alive[t][kill] = False
    return out_scores.astype(np.float32), path_id.astype(np.int32)


def seq_nms_batch_host(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                       max_paths: int = 100, rescore: str = "avg", offset: float = 1.0):
    """Per-class loop of :func:`seq_nms_single_host`: boxes (T, N, 4) shared,
    scores/mask (C, T, N) → out_scores (C, T, N), path_id (C, T, N)."""
    outs, pids = [], []
    for c in range(scores.shape[0]):
        o, p = seq_nms_single_host(boxes, scores[c], mask[c], link_thresh, suppress_thresh,
                                   max_paths=max_paths, rescore=rescore, offset=offset)
        outs.append(o)
        pids.append(p)
    return np.stack(outs), np.stack(pids)
