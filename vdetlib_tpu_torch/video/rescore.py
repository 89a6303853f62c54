"""Temporal tubelet rescoring — counterpart of ``vdetlib_tpu/video/rescore.py``.

Detections are matched to tracks by IoU per frame; each (track, class) gets
the top-k mean of its matched detection scores over the tubelet, and each
detection takes the best statistic among the tracks matching it.
``RescoreOptions`` holds the stage's options (the pipeline config tree reads
them); the staged stage (``tubelet_rescore``) is not ported yet (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vdetlib_tpu_torch.geometry.boxes import pairwise_iou

__all__ = ["RescoreOptions", "rescore_arrays"]


@dataclass(frozen=True)
class RescoreOptions:
    """Same fields and defaults as the JAX ``RescoreOptions``."""

    match_thresh: float = 0.5  # det ↔ track-box IoU match
    top_ratio: float = 0.5  # statistic = mean of the top this-fraction scores
    boost: str = "max"  # det new score: max(score, stat) | "mean"
    bg_decay: float = 1.0  # multiplier for dets on no tubelet (1.0 = keep)
    # track-quality gate: a track boosts only if dets match it on at least
    # this fraction of its live frames (0.0 = off)
    min_matched_frac: float = 0.0
    # length prior: the top-k mean's denominator is at least this many frames
    stat_floor: int = 0
    max_boxes: int = 64
    num_classes: int = 31
    max_tracks: int = 64
    # tubelet boxes as detections: not ported yet (FusedPipeline raises)
    tubelet_boxes: bool = False


def rescore_arrays(det_boxes, det_scores, det_mask, trk_boxes, trk_mask, match_thresh: float,
                   bg_decay: float, top_ratio: float = 0.5, boost: str = "max",
                   min_matched_frac: float = 0.0, stat_floor: float = 0.0):
    """Core rescoring math (the JAX ``rescore_arrays`` without ``trk_cls_scores``).

    Args:
      det_boxes (T, N, 4), det_scores (T, N, C), det_mask (T, N),
      trk_boxes (K, T, 4), trk_mask (K, T).
    Returns:
      new_scores (T, N, C), tubelet_stats (K, C), matched_any (K, T) bool.
    """
    T, N, C = det_scores.shape
    iou = pairwise_iou(trk_boxes.transpose(0, 1), det_boxes)  # (T, K, N)
    match = (iou > match_thresh) & det_mask[:, None, :] & trk_mask.transpose(0, 1)[:, :, None]
    zero = det_scores.new_zeros(())
    # per (track, frame, class): best matched det score
    per_tf = torch.where(match[..., None], det_scores[:, None, :, :], zero).amax(2)
    per_tf = per_tf.transpose(0, 1)  # (K, T, C)
    # top-k mean over the tubelet's frames (k = ceil(top_ratio * live length))
    live = trk_mask.sum(1).float()  # (K,)
    k_each = torch.clamp(torch.ceil(live * top_ratio), min=1.0)
    sorted_scores = torch.sort(per_tf, dim=1, descending=True).values
    ranks = torch.arange(T, dtype=torch.float32, device=det_scores.device)[None, :, None]
    topk_mask = ranks < k_each[:, None, None]
    stats = torch.sum(sorted_scores * topk_mask, dim=1) / torch.clamp(
        topk_mask.sum(1).float(), min=max(float(stat_floor), 1.0)
    )  # (K, C) — denominator floored at stat_floor (length prior)
    # track-quality gate (trivially open at min_matched_frac = 0)
    matched_tk = match.any(2)  # (T, K)
    matched_frac = matched_tk.sum(0).float() / torch.clamp(live, min=1.0)
    stats = stats * (matched_frac >= min_matched_frac)[:, None]
    # each det takes the best stat among tracks matching it
    stat_per_det = torch.where(match[..., None], stats[None, :, None, :], zero).amax(1)
    on_track = match.any(1)  # (T, N)
    if boost == "max":
        boosted = torch.maximum(det_scores, stat_per_det)
    else:
        boosted = 0.5 * (det_scores + torch.maximum(det_scores, stat_per_det))
    new_scores = torch.where(on_track[..., None], boosted, det_scores * bg_decay)
    new_scores = new_scores * det_mask[..., None]
    return new_scores, stats, matched_tk.transpose(0, 1)
