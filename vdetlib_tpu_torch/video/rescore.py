"""Temporal tubelet rescoring — counterpart of ``vdetlib_tpu/video/rescore.py``.

Detections are matched to tracks by IoU per frame; each (track, class) gets
the top-k mean of its matched detection scores over the tubelet (and of the
perturbation stage's max-pooled scores, where the track_proto carries them),
and each detection takes the best statistic among the tracks matching it.
:func:`rescore_arrays` is the math on tensors (the fused pipeline calls it
on the card); :func:`tubelet_rescore` is the staged stage over protos, with
the tubelet-box gap injection in host numpy after it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import pairwise_iou
from vdetlib_tpu_torch.protos.accessors import frame_ids as get_frame_ids
from vdetlib_tpu_torch.protos.accessors import score_proto_from_track_proto
from vdetlib_tpu_torch.protos.arrays import (
    arrays_to_det_proto,
    det_proto_to_arrays,
    track_cls_scores_to_arrays,
    track_proto_to_arrays,
)
from vdetlib_tpu_torch.utils.log import StageMetrics

__all__ = ["RescoreOptions", "rescore_arrays", "tubelet_rescore"]


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
    # tubelet boxes as detections: live track boxes with no matched detection
    # between matched frames enter the det set (tubelet_rescore here, the
    # same rule on the card in the fused pipeline)
    tubelet_boxes: bool = False


def rescore_arrays(det_boxes, det_scores, det_mask, trk_boxes, trk_mask, match_thresh: float,
                   bg_decay: float, top_ratio: float = 0.5, boost: str = "max",
                   trk_cls_scores=None, min_matched_frac: float = 0.0, stat_floor: float = 0.0):
    """Core rescoring math, with the JAX ``rescore_arrays``'s signature.

    ``trk_cls_scores`` (K, T, C), per-track-box detector evidence (the
    perturbation stage's max-pooled scores), enters the tubelet statistic
    beside the IoU-matched detection scores.

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
    if trk_cls_scores is not None:
        per_tf = torch.maximum(per_tf, trk_cls_scores * trk_mask[..., None])
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


@torch.no_grad()
def tubelet_rescore(vid_proto: dict, det_proto: dict, track_proto: dict,
                    opts: RescoreOptions = RescoreOptions(), device="cuda") -> tuple[dict, dict]:
    """Full rescoring stage → (score_proto, rescored det_proto).

    :func:`rescore_arrays` runs on ``device`` (the card unless the caller
    asks for the CPU); the perturbation stage's ``perturb_scores`` enter
    when the track_proto carries any. With ``tubelet_boxes`` each track's
    live boxes that match no detection, between frames where it does match
    one, are appended after the detection slots, scored by the track's
    statistic (host numpy, as in the JAX stage)."""
    metrics = StageMetrics("rescore")
    dev = torch.device(device)
    fids = get_frame_ids(vid_proto)
    det_boxes, det_scores, det_mask = det_proto_to_arrays(det_proto, fids, opts.max_boxes,
                                                          opts.num_classes)
    trk_boxes, _, trk_mask = track_proto_to_arrays(track_proto, fids, max_tracks=opts.max_tracks)
    trk_cls, has_perturb = track_cls_scores_to_arrays(track_proto, fids, opts.num_classes,
                                                      max_tracks=opts.max_tracks)
    if trk_boxes.shape[0] == 0:
        trk_boxes = np.zeros((1, len(fids), 4), np.float32)
        trk_mask = np.zeros((1, len(fids)), bool)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    new_scores, stats, matched_any = rescore_arrays(
        put(det_boxes), put(det_scores), put(det_mask), put(trk_boxes), put(trk_mask),
        opts.match_thresh, opts.bg_decay, top_ratio=opts.top_ratio, boost=opts.boost,
        trk_cls_scores=put(trk_cls) if has_perturb else None,
        min_matched_frac=opts.min_matched_frac, stat_floor=float(opts.stat_floor),
    )
    new_scores = new_scores.cpu().numpy()
    stats = stats.cpu().numpy()
    matched_any = matched_any.cpu().numpy()

    out_boxes, out_scores, out_mask = det_boxes, new_scores, det_mask
    if opts.tubelet_boxes:
        # gap filling: live unmatched track boxes append AFTER the det slots
        # (the link stage's file-order budget sees detections first)
        K, C, T = trk_boxes.shape[0], new_scores.shape[-1], len(fids)
        # interior gaps only: matched frames on both sides
        has_before = np.cumsum(matched_any, axis=1) > 0
        has_after = np.flip(np.cumsum(np.flip(matched_any, axis=1), axis=1), axis=1) > 0
        inj_valid = (trk_mask & ~matched_any & has_before & has_after
                     & (stats[:, 1:].max(axis=1) > 0)[:, None])  # (K, T)
        inj_scores = (np.broadcast_to(stats[:, None, :], (K, T, C))
                      * inj_valid[..., None]).astype(np.float32)
        out_boxes = np.concatenate([det_boxes, np.swapaxes(trk_boxes, 0, 1)], axis=1)
        out_scores = np.concatenate([new_scores, np.swapaxes(inj_scores, 0, 1)], axis=1)
        out_mask = np.concatenate([det_mask, inj_valid.T], axis=1)

    det_out = arrays_to_det_proto(out_boxes, out_scores, out_mask, fids, vid_proto["video"],
                                  score_thresh=0.0)
    n_tracks = len(track_proto["tracks"])
    per_track_stats = [
        {c: float(stats[k, c]) for c in range(1, opts.num_classes) if stats[k, c] > 0}
        for k in range(min(n_tracks, opts.max_tracks))
    ] + [{} for _ in range(max(0, n_tracks - opts.max_tracks))]
    score_proto = score_proto_from_track_proto(track_proto, per_track_stats)
    metrics.set("frames", len(fids))
    metrics.set("tracks", n_tracks)
    metrics.finish()
    return score_proto, det_out
