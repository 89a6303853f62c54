"""The fused T-CNN pipeline over one video in plain PyTorch.

A frozen copy of the port's fused pipeline (``pipeline/fused.py``) and the
stage functions it calls, with the options the benchmark's configurations
state (one MGP hop window, no snapping, no tubelet boxes): detection in
``detect_batch`` chunks → slot packing with the per-frame budget → flow both
ways and the MGP hops → per-frame per-class NMS dedup → greedy anchor rounds
of forward+backward correlation tracking → tubelet rescoring → seq-NMS.
``cfg`` is a configuration's ``fused`` mapping (attribute access).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.boxes import apply_deltas, clip_boxes, pairwise_iou, shift_boxes
from portbench.reference.flow import FLOW_PRESET_POOL, flow_video, mean_flow_in_boxes
from portbench.reference.nets import preprocess_images, tracker_features
from portbench.reference.nms import nms_grouped
from portbench.reference.seq_nms import seq_nms_batch
from portbench.reference.track import track_batch


def detect_step(det, images_u8, rois):
    """(B, H, W, 3) uint8 + (B, R, 4) rois → probs (B, R, K), boxes (B, R, K, 4)."""
    scores, deltas = det(preprocess_images(images_u8, det.arch), rois)
    probs = torch.softmax(scores, dim=-1)
    H, W = images_u8.shape[1:3]
    return probs, clip_boxes(apply_deltas(rois[:, :, None, :], deltas), H, W)


def propagate_hop(flow_t, boxes_t, mask_t, coord_scale: float):
    """Boxes at t shifted by their mean flow → boxes for the next frame."""
    return shift_boxes(boxes_t, mean_flow_in_boxes(flow_t, boxes_t * coord_scale, mask_t))


def rescore_arrays(det_boxes, det_scores, det_mask, trk_boxes, trk_mask, cfg):
    """Tubelet rescoring: each (track, class) takes the top-k mean of its
    IoU-matched detection scores; a detection takes the best statistic of
    the tracks matching it → new scores (T, N, C)."""
    T, N, C = det_scores.shape
    iou = pairwise_iou(trk_boxes.transpose(0, 1), det_boxes)
    match = ((iou > cfg.rescore_match) & det_mask[:, None, :]
             & trk_mask.transpose(0, 1)[:, :, None])
    zero = det_scores.new_zeros(())
    per_tf = torch.where(match[..., None], det_scores[:, None, :, :], zero).amax(2)
    per_tf = per_tf.transpose(0, 1)
    live = trk_mask.sum(1).float()
    k_each = torch.clamp(torch.ceil(live * cfg.top_ratio), min=1.0)
    sorted_scores = torch.sort(per_tf, dim=1, descending=True).values
    ranks = torch.arange(T, dtype=torch.float32, device=det_scores.device)[None, :, None]
    topk_mask = ranks < k_each[:, None, None]
    stats = torch.sum(sorted_scores * topk_mask, dim=1) / torch.clamp(
        topk_mask.sum(1).float(), min=max(float(cfg.stat_floor), 1.0))
    matched_tk = match.any(2)
    matched_frac = matched_tk.sum(0).float() / torch.clamp(live, min=1.0)
    stats = stats * (matched_frac >= cfg.min_matched_frac)[:, None]
    stat_per_det = torch.where(match[..., None], stats[None, :, None, :], zero).amax(1)
    on_track = match.any(1)
    if cfg.boost == "max":
        boosted = torch.maximum(det_scores, stat_per_det)
    else:
        boosted = 0.5 * (det_scores + torch.maximum(det_scores, stat_per_det))
    new_scores = torch.where(on_track[..., None], boosted, det_scores * cfg.bg_decay)
    return new_scores * det_mask[..., None]


def _compact_by_rank(idx, budget: int, *arrays):
    """Scatter flat per-frame slots (T, M, ...) to their file-order rank."""
    out = []
    for a in arrays:
        T = a.shape[0]
        z = torch.zeros((T, budget + 1) + a.shape[2:], dtype=a.dtype, device=a.device)
        ix = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(a.shape)
        out.append(z.scatter(1, ix, a)[:, :budget])
    return tuple(out)


def _rank_mask(mask, budget: int):
    """File-order budget: keep an entry iff its rank among kept < budget."""
    m = mask.to(torch.int32)
    rank = torch.cumsum(m, dim=1) - m
    kept = mask & (rank < budget)
    return kept, torch.where(kept, rank, torch.full_like(rank, budget)).long()


def greedy_track_rounds(arch, prec, cfg, feats, cand_boxes, cand_scores, cand_mask, frame_ok):
    """Rounds of {pick up to A top-score uncovered candidates, skipping one
    that overlaps a same-frame pick of the round; track the picks forward
    and backward; cover the candidates the new tracks overlap}, ceil(K/A)
    self-gated rounds → boxes (K, T, 4), conf (K, T), alive (K, T)."""
    T, M = cand_scores.shape
    F = T * M
    A, K = cfg.anchors_per_round, cfg.max_tracks
    dev = cand_scores.device
    b_flat = cand_boxes.reshape(F, 4)
    s_flat = cand_scores.reshape(F)
    m_flat = cand_mask.reshape(F)
    t_flat = torch.arange(F, device=dev) // M
    slot_ar = torch.arange(F, device=dev)
    neg_inf = s_flat.new_full((), float("-inf"))
    valid_t = frame_ok.sum()
    covered = torch.zeros(F, dtype=torch.bool, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    out_b = torch.zeros((K + 1, T, 4), dtype=torch.float32, device=dev)
    out_c = torch.zeros((K + 1, T), dtype=torch.float32, device=dev)
    out_a = torch.zeros((K + 1, T), dtype=torch.bool, device=dev)
    for _ in range(math.ceil(K / A)):
        room = K - n
        avail = m_flat & ~covered
        picks, valids = [], []
        for k in range(A):
            s = torch.where(avail, s_flat, neg_inf)
            i = torch.argmax(s)
            ok = (s[i] > neg_inf) & (room > k)
            clash = (t_flat == t_flat[i]) & (
                pairwise_iou(b_flat[i][None], b_flat)[0] > cfg.cover_thresh)
            avail = torch.where(ok, avail & ~clash & (slot_ar != i), avail)
            picks.append(torch.where(ok, i, torch.zeros_like(i)))
            valids.append(ok)
        picks = torch.stack(picks)
        valids = torch.stack(valids)
        tb, tc, ta = track_batch(arch, prec, feats, t_flat[picks], b_flat[picks], cfg.track_conf,
                                cfg.track_stride, T, valid_t)
        ta = ta & valids[:, None] & frame_ok[None, :]
        slot = torch.where(valids, n + torch.cumsum(valids.long(), 0) - 1,
                           torch.full_like(picks, K))
        out_b = out_b.index_put((slot,), tb)
        out_c = out_c.index_put((slot,), tc)
        out_a = out_a.index_put((slot,), ta)
        iou_atm = pairwise_iou(tb[:, :, None, :], cand_boxes[None])[:, :, 0]
        cov = ((iou_atm > cfg.cover_thresh) & ta[:, :, None]).any(0)
        covered = covered | cov.reshape(F)
        hit = torch.zeros(F, dtype=torch.int32, device=dev).index_add_(0, picks, valids.int())
        covered = covered | (hit > 0)
        n = n + valids.sum()
    return out_b[:K], out_c[:K], out_a[:K]


@torch.no_grad()
def fused_video(det, trk, cfg, frames, rois, t_valid: int, roi_mask, tracks=None):
    """One bucket-padded video: frames (T, H, W, 3) uint8, rois (T, R, 4),
    roi_mask (T, R) → dict of numpy arrays: ``boxes`` (T, Nb, 4), ``mask``
    (T, Nb) and ``final`` (C-1, T, Nb) seq-NMS scores (-1 suppressed); the
    tracks ``track_boxes`` (K, T, 4), ``track_conf`` and ``track_alive``
    (K, T), the conf only where the reference tracked itself; the anchor
    candidates ``cand_boxes`` (T, M, 4) and ``cand_mask`` (T, M).
    ``tracks``: (boxes, alive) tensors that take the place of the greedy
    tracker's, which then does not run."""
    B = cfg.detect_batch
    outs = [detect_step(det, frames[i:i + B], rois[i:i + B]) for i in range(0, frames.shape[0], B)]
    probs = torch.cat([p for p, _ in outs])
    reg_boxes = torch.cat([b for _, b in outs])
    T, R, C = probs.shape
    dev = probs.device
    frame_ok = torch.arange(T, device=dev) < t_valid

    M0 = R * (C - 1)
    s_flat = probs[:, :, 1:].reshape(T, M0)
    b_flat = reg_boxes[:, :, 1:, :].reshape(T, M0, 4)
    cls_flat = torch.arange(1, C, dtype=torch.int32, device=dev).repeat(R)[None].expand(T, M0)
    m_flat = ((s_flat >= cfg.score_thresh) & roi_mask.repeat_interleave(C - 1, dim=1)
              & frame_ok[:, None])
    kept0, idx0 = _rank_mask(m_flat, cfg.det_budget)
    dboxes, dscores, dcls, dmask = _compact_by_rank(idx0, cfg.det_budget, b_flat, s_flat,
                                                    cls_flat, kept0)

    N0 = cfg.det_budget
    w = cfg.mgp_window
    coord_scale = 1.0 / FLOW_PRESET_POOL[cfg.flow_preset]
    fwd = flow_video(frames, det.prec.flow, preset=cfg.flow_preset)
    bwd = flow_video(frames.flip(0), det.prec.flow, preset=cfg.flow_preset).flip(0)
    zb = dboxes.new_zeros((1, N0, 4))
    zm = dmask.new_zeros((1, N0))
    blk_boxes, blk_scores, blk_mask, blk_cls = [dboxes], [dscores], [dmask], [dcls]
    cur_b, cur_m = dboxes, dmask
    for h in range(1, w + 1):
        nb = propagate_hop(fwd, cur_b[:-1], cur_m[:-1], coord_scale)
        cur_b = torch.cat([zb, nb])
        cur_m = torch.cat([zm, cur_m[:-1]])
        src = torch.cat([dscores.new_zeros((h, N0)), dscores[:-h]])
        blk_boxes.append(cur_b)
        blk_scores.append(src * (cfg.mgp_decay ** h))
        blk_mask.append(cur_m & frame_ok[:, None])
        blk_cls.append(torch.cat([dcls.new_zeros((h, N0)), dcls[:-h]]))
    cur_b, cur_m = dboxes, dmask
    for h in range(1, w + 1):
        nb = propagate_hop(bwd, cur_b[1:], cur_m[1:], coord_scale)
        cur_b = torch.cat([nb, zb])
        cur_m = torch.cat([cur_m[1:], zm])
        src = torch.cat([dscores[h:], dscores.new_zeros((h, N0))])
        blk_boxes.append(cur_b)
        blk_scores.append(src * (cfg.mgp_decay ** h))
        blk_mask.append(cur_m & frame_ok[:, None])
        blk_cls.append(torch.cat([dcls[h:], dcls.new_zeros((h, N0))]))
    g_boxes = torch.cat(blk_boxes, dim=1)
    g_scores = torch.cat(blk_scores, dim=1)
    g_mask = torch.cat(blk_mask, dim=1)
    g_cls = torch.cat(blk_cls, dim=1)
    g_valid = g_mask & (g_scores > 0)
    keep = nms_grouped(g_boxes, g_scores, g_valid, g_cls, cfg.nms_thresh) & g_valid

    cand_mask = keep & (g_scores >= cfg.anchor_thresh)
    if tracks is None:
        s = int(cfg.track_stride)
        fr_src = frames[::s] if s > 1 else frames
        fb = cfg.feat_batch
        feats = torch.cat([tracker_features(trk, fr_src[i:i + fb])
                           for i in range(0, fr_src.shape[0], fb)])
        tb, tc, ta = greedy_track_rounds(trk.arch, trk.prec, cfg, feats, g_boxes, g_scores,
                                         cand_mask, frame_ok)
    else:
        (tb, ta), tc = tracks, None

    kept2, idx2 = _rank_mask(keep, cfg.out_budget)
    oboxes, oscores, ocls, omask = _compact_by_rank(idx2, cfg.out_budget, g_boxes, g_scores,
                                                    g_cls, kept2)
    onehot = torch.nn.functional.one_hot(ocls.long(), C).to(oscores.dtype)
    oscores_vec = onehot * oscores[..., None] * omask[..., None]
    new_scores = rescore_arrays(oboxes, oscores_vec, omask, tb, ta, cfg)

    cls_scores = new_scores[:, :, 1:].permute(2, 0, 1)
    cls_mask = (cls_scores > 0) & omask[None]
    final, _ = seq_nms_batch(oboxes, cls_scores, cls_mask, cfg.link_thresh,
                             cfg.suppress_thresh, max_paths=cfg.max_paths,
                             rescore=cfg.link_rescore)
    return {"boxes": oboxes.cpu().numpy(), "mask": omask.cpu().numpy(),
            "final": final.cpu().numpy(), "track_boxes": tb.cpu().numpy(),
            "track_conf": None if tc is None else tc.cpu().numpy(),
            "track_alive": ta.cpu().numpy(), "cand_boxes": g_boxes.cpu().numpy(),
            "cand_mask": cand_mask.cpu().numpy()}


def pad_snippet(frames_u8: np.ndarray, rois: np.ndarray, bucket: int):
    """Pad a (T, ...) snippet to the next multiple of ``bucket`` (repeating
    the last frame, zero proposals) → (frames, rois, T)."""
    T = frames_u8.shape[0]
    Tp = max(((T + bucket - 1) // bucket) * bucket, bucket)
    if Tp == T:
        return frames_u8, rois, T
    fpad = np.repeat(frames_u8[-1:], Tp - T, axis=0)
    rpad = np.zeros((Tp - T,) + rois.shape[1:], rois.dtype)
    return np.concatenate([frames_u8, fpad], axis=0), np.concatenate([rois, rpad], axis=0), T
