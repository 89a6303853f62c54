"""Seq-NMS tubelet linking in plain PyTorch (a frozen copy of the port's
``seq_nms_batch``): repeat {Viterbi max-score path over the frame adjacency
(IoU > link_thresh between consecutive frames) → rescore the path to its
average → remove it and suppress per-frame overlaps}, classes as a batch
axis, ``max_paths`` self-gated rounds.
"""

from __future__ import annotations

import torch

from portbench.reference.boxes import LEGACY_OFFSET, pairwise_iou

NEG = -1e30


def seq_nms_batch(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                  max_paths: int = 100, rescore: str = "avg", offset: float = LEGACY_OFFSET):
    """Per-class seq-NMS.

    Args:
      boxes: (T, N, 4) shared across classes; scores: (C, T, N); mask: (C, T, N) bool.
    Returns:
      out_scores (C, T, N): path boxes carry the path statistic, suppressed
        boxes -1, untouched boxes their score; path_id (C, T, N) int32, -1 = none.
    """
    Cb, T, N = scores.shape
    dev = scores.device
    neg = scores.new_full((), NEG)
    adj = pairwise_iou(boxes[:-1], boxes[1:], offset=offset) > link_thresh  # (T-1, N, N)
    # one unlinked slab at the end keeps adj[t] indexable at t = 0 when T = 1
    adj = torch.cat([adj, adj.new_zeros((1, N, N))], dim=0)
    lanes = torch.arange(Cb, device=dev)
    alive = mask.clone()
    out_scores = scores * mask
    path_id = torch.full((Cb, T, N), -1, dtype=torch.int32, device=dev)
    n_paths = torch.zeros(Cb, dtype=torch.int32, device=dev)

    def viterbi(alive):
        """Forward DP → dp (C, T, N): best path score ending at each box."""
        s = torch.where(alive, scores, neg)
        dp = [torch.where(alive[:, 0], scores[:, 0], neg)]
        for t in range(1, T):
            # max-plus product over linked, alive predecessors
            cand = torch.where(adj[t - 1][None], dp[-1][:, :, None], neg)  # (C, Nprev, N)
            prev_best = cand.amax(1)
            dp.append(torch.where(alive[:, t], s[:, t] + torch.clamp(prev_best, min=0.0), neg))
        return torch.stack(dp, 1)

    def extract_path(dp):
        """Backtrack each lane's global best path → onehot (C, T, N), best (C,)."""
        flat = torch.argmax(dp.reshape(Cb, T * N), dim=1)
        t = flat // N
        cur = flat % N
        best = dp.reshape(Cb, T * N)[lanes, flat]
        walking = best > 0
        onehot = torch.zeros((Cb, T, N), dtype=torch.bool, device=dev)
        for _ in range(T):
            onehot[lanes, t, cur] |= walking
            tp = torch.clamp(t - 1, min=0)
            col = adj[tp, :, cur]  # (C, N) edges (t-1 → t) into cur
            cand = torch.where(col, dp[lanes, tp], neg)
            nxt = torch.argmax(cand, dim=1)
            ok = walking & (t > 0) & (cand[lanes, nxt] > 0)
            t = tp
            cur = torch.where(ok, nxt, cur)
            walking = ok
        return onehot, best

    for _ in range(max_paths):
        dp = viterbi(alive)
        onehot_raw, best = extract_path(dp)
        active = (best > 0) & (n_paths < max_paths)
        onehot = onehot_raw & alive & active[:, None, None]
        frame_on_path = onehot.any(2)  # (C, T)
        path_scores = torch.where(onehot, scores, torch.zeros_like(scores)).sum(2)
        if rescore == "avg":
            n_on = torch.clamp(frame_on_path.sum(1), min=1)
            stat = torch.where(frame_on_path, path_scores, torch.zeros_like(path_scores)).sum(1) / n_on
        else:
            stat = torch.where(frame_on_path, path_scores, neg).amax(1)
        out_scores = torch.where(onehot, stat[:, None, None], out_scores)
        path_id = torch.where(onehot, n_paths[:, None, None], path_id)
        alive = alive & ~onehot
        # per-frame suppression against the path box
        path_box = torch.where(onehot[..., None], boxes[None], 0.0).sum(2)  # (C, T, 4)
        iou_row = pairwise_iou(path_box[:, :, None, :], boxes[None], offset=offset)[:, :, 0]
        kill = (iou_row > suppress_thresh) & frame_on_path[:, :, None] & alive
        out_scores = torch.where(kill, torch.full_like(out_scores, -1.0), out_scores)
        alive = alive & ~kill
        n_paths = n_paths + active.to(torch.int32)
    return out_scores, path_id
