"""Fused pipeline — counterpart of ``vdetlib_tpu/pipeline/fused.py``.

The whole T-CNN flow on one snippet, device-resident: detection → slot
packing with the per-frame budget → optical-flow MGP hop + grouped per-class
NMS dedup → greedy-anchor correlation tracking → tubelet rescoring →
seq-NMS linking. Same stage math as the JAX program; it runs eagerly (no
``jit``), and the JAX ``while_loop``s are fixed-trip loops with self-gated
updates, so the host never waits on the card inside the pipeline.

:class:`FusedPipeline` splits the body where the JAX program moves from
detection to the temporal stages: :meth:`FusedPipeline.detect` gives
``(probs, reg_boxes)`` and :meth:`FusedPipeline.temporal` takes them, so a
test can feed the JAX detection outputs to the torch temporal stages.
:func:`make_sharded_pipeline` splits a batch of snippets across the ranks of
a ``torch.distributed`` mesh (``dist/sharding.py``).

Each stage runs under a ``torch.profiler.record_function`` span named
``fused.<stage>``, inside one ``fused.pipeline`` span a call, so a profiler
trace splits the pipeline's time by stage and leaves the glue between them
(slot packing, the MGP hops, the output budget) to the parent span.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from vdetlib_tpu_torch.dist.sharding import data_rank_size
from vdetlib_tpu_torch.geometry.boxes import pairwise_iou
from vdetlib_tpu_torch.kernels.flow import flow_coord_scale, flow_video
from vdetlib_tpu_torch.kernels.nms import nms_grouped
from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_batch
from vdetlib_tpu_torch.video.detect import _detect_step
from vdetlib_tpu_torch.video.mgp import _propagate_hop
from vdetlib_tpu_torch.video.rescore import rescore_arrays
from vdetlib_tpu_torch.video.track import track_batch, tracker_features


@dataclass(frozen=True)
class FusedConfig:
    """Same fields and defaults as the JAX ``FusedConfig``."""

    image_hw: tuple = (240, 320)
    detect_batch: int = 16
    feat_batch: int = 16
    # detect
    score_thresh: float = 0.005
    # mgp
    mgp_window: int = 1
    mgp_decay: float = 0.9
    nms_thresh: float = 0.3
    det_budget: int = 64
    out_budget: int = 64
    # track
    max_tracks: int = 32
    anchors_per_round: int = 8
    anchor_thresh: float = 0.3
    track_conf: float = 0.5
    cover_thresh: float = 0.5
    snap_weight: float = 0.0  # detection snapping blend (0 = off)
    snap_iou: float = 0.5
    track_stride: int = 2
    # rescore
    rescore_match: float = 0.5
    top_ratio: float = 0.5
    boost: str = "max"
    bg_decay: float = 1.0
    min_matched_frac: float = 0.0
    stat_floor: int = 0
    # seq-NMS link
    link_thresh: float = 0.5
    suppress_thresh: float = 0.3
    max_paths: int = 100
    link_rescore: str = "avg"
    # tubelet boxes as detections: live unmatched track boxes in interior
    # gaps enter the det set before linking
    tubelet_boxes: bool = False
    # flow
    flow_preset: str = "fastest"
    flow_levels: int = 3
    flow_search: int = 3


class FusedOutput(NamedTuple):
    det_boxes: torch.Tensor  # (T, Nb, 4) post-MGP-NMS compacted slot boxes
    det_scores: torch.Tensor  # (T, Nb, C) rescored (pre-link) slot score vectors
    det_mask: torch.Tensor  # (T, Nb)
    final_scores: torch.Tensor  # (C-1, T, Nb) seq-NMS out (-1 = suppressed)
    path_ids: torch.Tensor  # (C-1, T, Nb) tubelet path ids (-1 = none)
    track_boxes: torch.Tensor  # (K, T, 4)
    track_conf: torch.Tensor  # (K, T)
    track_alive: torch.Tensor  # (K, T)
    n_tracks: torch.Tensor  # () int32
    tubelet_stats: torch.Tensor  # (K, C) rescoring per-track per-class stats


def _compact_by_rank(idx, budget: int, *arrays):
    """Scatter flat per-frame slots (T, M, ...) to their file-order rank.

    idx (T, M): rank among kept entries, or ``budget`` for dropped ones
    (they land in a dummy slot that is sliced off)."""
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
    rank = torch.cumsum(m, dim=1) - m  # exclusive
    kept = mask & (rank < budget)
    return kept, torch.where(kept, rank, torch.full_like(rank, budget)).long()


def _greedy_track_rounds(trk_cfg, cfg: FusedConfig, feats, cand_boxes, cand_scores,
                         cand_mask, frame_ok):
    """Greedy anchor selection + batched tracking (the staged host loop).

    Rounds of {pick up to A top-score uncovered candidates, skipping any
    that overlaps (IoU > cover_thresh) a same-frame pick of this round;
    track all picks fwd+bwd in one batch; mark candidates covered by the new
    tracks} until ``max_tracks`` or everything is covered. Ties break (score
    desc, file-order index asc): ``argmax`` returns the first maximum.

    Fixed trip count ceil(K/A): a round that picks fewer than A anchors
    either fills the K budget or leaves every candidate covered (a clashing
    candidate overlaps its pick's anchor box, which the pick's track holds
    at that frame), so no further round can pick; every update is gated on
    the round's valid picks, so a round with none changes nothing.
    """
    T, M = cand_scores.shape
    F = T * M
    A = cfg.anchors_per_round
    K = cfg.max_tracks
    dev = cand_scores.device
    # detection snapping uses the anchor-candidate set, the set the staged
    # track_from_det builds; snap_to_dets does not depend on slot order, so
    # the engines' different packings of it snap alike
    snap = (cand_boxes, cand_scores, cand_mask) if cfg.snap_weight > 0.0 else None
    b_flat = cand_boxes.reshape(F, 4)
    s_flat = cand_scores.reshape(F)
    m_flat = cand_mask.reshape(F)
    t_flat = torch.arange(F, device=dev) // M
    slot_ar = torch.arange(F, device=dev)
    neg_inf = s_flat.new_full((), float("-inf"))
    stride = int(cfg.track_stride)
    valid_t = frame_ok.sum() if stride > 1 else None

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
                pairwise_iou(b_flat[i][None], b_flat)[0] > cfg.cover_thresh
            )
            avail = torch.where(ok, avail & ~clash & (slot_ar != i), avail)
            picks.append(torch.where(ok, i, torch.zeros_like(i)))
            valids.append(ok)
        picks = torch.stack(picks)
        valids = torch.stack(valids)
        tb, tc, ta = track_batch(
            trk_cfg, feats, t_flat[picks], b_flat[picks], cfg.track_conf, snap=snap,
            snap_iou=cfg.snap_iou, snap_weight=cfg.snap_weight, frame_stride=stride,
            feats_strided=stride > 1, full_t=T if stride > 1 else None, valid_t=valid_t,
        )
        ta = ta & valids[:, None] & frame_ok[None, :]
        # K-slot scatter in pick order (invalid lanes land in the dummy row)
        slot = torch.where(valids, n + torch.cumsum(valids.long(), 0) - 1, torch.full_like(picks, K))
        out_b = out_b.index_put((slot,), tb)
        out_c = out_c.index_put((slot,), tc)
        out_a = out_a.index_put((slot,), ta)
        # coverage: candidates overlapping a live track box at their frame
        iou_atm = pairwise_iou(tb[:, :, None, :], cand_boxes[None])[:, :, 0]  # (A, T, M)
        cov = ((iou_atm > cfg.cover_thresh) & ta[:, :, None]).any(0)
        covered = covered | cov.reshape(F)
        hit = torch.zeros(F, dtype=torch.int32, device=dev).index_add_(0, picks, valids.int())
        covered = covered | (hit > 0)
        n = n + valids.sum()
    return out_b[:K], out_c[:K], out_a[:K], n.to(torch.int32)


class FusedPipeline:
    """The fused pipeline over one snippet; see :func:`make_fused_pipeline`."""

    def __init__(self, det_model, trk_model, trk_cfg, cfg: FusedConfig):
        self.det_model = det_model
        self.trk_model = trk_model
        self.trk_cfg = trk_cfg
        self.cfg = cfg

    @torch.no_grad()
    def __call__(self, frames, rois, t_valid=None, roi_mask=None) -> FusedOutput:
        """frames (T, H, W, 3) uint8, rois (T, R, 4) → :class:`FusedOutput`.

        ``t_valid`` masks padded tail frames (see :func:`pad_snippet`);
        ``roi_mask`` (T, R) masks padded proposal slots."""
        with record_function("fused.pipeline"):
            probs, reg_boxes = self.detect(frames, rois)
            return self.temporal(frames, probs, reg_boxes, t_valid, roi_mask)

    @torch.no_grad()
    def detect(self, frames, rois):
        """Detection in ``detect_batch`` chunks → probs (T, R, C), boxes (T, R, C, 4)."""
        B = self.cfg.detect_batch
        with record_function("fused.detect"):
            out = [
                _detect_step(self.det_model, frames[i : i + B], rois[i : i + B], True)
                for i in range(0, frames.shape[0], B)
            ]
            return torch.cat([p for p, _ in out]), torch.cat([b for _, b in out])

    @torch.no_grad()
    def temporal(self, frames, probs, reg_boxes, t_valid=None, roi_mask=None) -> FusedOutput:
        """Every stage after detection, from its outputs (probs, reg_boxes)."""
        cfg = self.cfg
        T, R, C = probs.shape
        dev = probs.device
        w = cfg.mgp_window
        t_ar = torch.arange(T, device=dev)
        frame_ok = torch.ones(T, dtype=torch.bool, device=dev) if t_valid is None else t_ar < t_valid
        if roi_mask is None:
            roi_mask = torch.ones((T, R), dtype=torch.bool, device=dev)

        # ---- slot packing: one entry per (roi, class>=1) over score_thresh,
        # file order (roi-major, class-minor), first det_budget per frame
        M0 = R * (C - 1)
        s_flat = probs[:, :, 1:].reshape(T, M0)
        b_flat = reg_boxes[:, :, 1:, :].reshape(T, M0, 4)
        cls_flat = torch.arange(1, C, dtype=torch.int32, device=dev).repeat(R)[None].expand(T, M0)
        m_flat = (
            (s_flat >= cfg.score_thresh)
            & roi_mask.repeat_interleave(C - 1, dim=1)
            & frame_ok[:, None]
        )
        kept0, idx0 = _rank_mask(m_flat, cfg.det_budget)
        dboxes, dscores, dcls, dmask = _compact_by_rank(
            idx0, cfg.det_budget, b_flat, s_flat, cls_flat, kept0
        )

        # ---- MGP: flow both ways, then hop the det set ±w frames. Every
        # attribute of a propagated block comes from its SOURCE frame.
        N0 = cfg.det_budget
        coord_scale = flow_coord_scale(cfg.flow_preset)
        flow_kw = dict(levels=cfg.flow_levels, search=cfg.flow_search,
                       preset=cfg.flow_preset, upsample=(coord_scale == 1.0))
        with record_function("fused.flow"):
            fwd = flow_video(frames, **flow_kw)  # (T-1, h, w, 2): t → t+1
            bwd = flow_video(frames.flip(0), **flow_kw).flip(0)  # bwd[t]: t+1 → t
        zb = dboxes.new_zeros((1, N0, 4))
        zm = dmask.new_zeros((1, N0))
        blk_boxes, blk_scores, blk_mask, blk_cls = [dboxes], [dscores], [dmask], [dcls]
        cur_b, cur_m = dboxes, dmask
        for h in range(1, w + 1):  # forward hops: det at t lands at t+h
            nb = _propagate_hop(fwd, cur_b[:-1], cur_m[:-1], coord_scale)
            cur_b = torch.cat([zb, nb])
            cur_m = torch.cat([zm, cur_m[:-1]])
            src = torch.cat([dscores.new_zeros((h, N0)), dscores[:-h]])
            blk_boxes.append(cur_b)
            blk_scores.append(src * (cfg.mgp_decay ** h))
            blk_mask.append(cur_m & frame_ok[:, None])
            blk_cls.append(torch.cat([dcls.new_zeros((h, N0)), dcls[:-h]]))
        cur_b, cur_m = dboxes, dmask
        for h in range(1, w + 1):  # backward hops: det at t lands at t-h
            nb = _propagate_hop(bwd, cur_b[1:], cur_m[1:], coord_scale)
            cur_b = torch.cat([nb, zb])
            cur_m = torch.cat([cur_m[1:], zm])
            src = torch.cat([dscores[h:], dscores.new_zeros((h, N0))])
            blk_boxes.append(cur_b)
            blk_scores.append(src * (cfg.mgp_decay ** h))
            blk_mask.append(cur_m & frame_ok[:, None])
            blk_cls.append(torch.cat([dcls[h:], dcls.new_zeros((h, N0))]))
        g_boxes = torch.cat(blk_boxes, dim=1)  # (T, M1, 4)
        g_scores = torch.cat(blk_scores, dim=1)
        g_mask = torch.cat(blk_mask, dim=1)
        g_cls = torch.cat(blk_cls, dim=1)

        # ---- per-frame per-class NMS dedup: one grouped fixpoint (kernel B)
        g_valid = g_mask & (g_scores > 0)
        with record_function("fused.nms_dedup"):
            keep = nms_grouped(g_boxes, g_scores, g_valid, g_cls, cfg.nms_thresh) & g_valid

        # ---- tracking: features only for the frames the strided scan reads
        s = int(cfg.track_stride)
        fr_src = frames[::s] if s > 1 else frames
        fb = cfg.feat_batch
        with record_function("fused.track_features"):
            feats = torch.cat([
                tracker_features(self.trk_model, fr_src[i : i + fb])
                for i in range(0, fr_src.shape[0], fb)
            ])
        cand_mask = keep & (g_scores >= cfg.anchor_thresh)
        with record_function("fused.track_rounds"):
            tb, tc, ta, n_tracks = _greedy_track_rounds(
                self.trk_cfg, cfg, feats, g_boxes, g_scores, cand_mask, frame_ok
            )

        # ---- output-budget truncation
        kept2, idx2 = _rank_mask(keep, cfg.out_budget)
        oboxes, oscores, ocls, omask = _compact_by_rank(
            idx2, cfg.out_budget, g_boxes, g_scores, g_cls, kept2
        )
        onehot = torch.nn.functional.one_hot(ocls.long(), C).to(oscores.dtype)
        oscores_vec = onehot * oscores[..., None] * omask[..., None]

        # ---- tubelet rescoring
        with record_function("fused.rescore"):
            new_scores, stats, matched_any = rescore_arrays(
                oboxes, oscores_vec, omask, tb, ta, cfg.rescore_match, cfg.bg_decay,
                top_ratio=cfg.top_ratio, boost=cfg.boost,
                min_matched_frac=cfg.min_matched_frac, stat_floor=float(cfg.stat_floor),
            )
            if cfg.tubelet_boxes:
                # live unmatched track boxes in INTERIOR gaps (matched frames
                # on both sides) become det slots scored by the tubelet
                # statistic; the union is rank-compacted to the output budget
                # in the staged link stage's order: dets first, then tracks
                # by index
                has_before = torch.cumsum(matched_any.int(), 1) > 0
                has_after = torch.cumsum(matched_any.int().flip(1), 1).flip(1) > 0
                inj_valid = (ta & ~matched_any & has_before & has_after
                             & (stats[:, 1:].amax(1) > 0)[:, None])  # (K, T)
                inj_scores = stats[:, None, :] * inj_valid[..., None]  # (K, T, C)
                u_boxes = torch.cat([oboxes, tb.transpose(0, 1)], dim=1)
                u_scores = torch.cat([new_scores, inj_scores.transpose(0, 1)], dim=1)
                u_mask = torch.cat([omask, inj_valid.transpose(0, 1)], dim=1)
                kept3, idx3 = _rank_mask(u_mask, cfg.out_budget)
                oboxes, new_scores, omask = _compact_by_rank(
                    idx3, cfg.out_budget, u_boxes, u_scores, kept3)

        # ---- seq-NMS linking
        cls_scores = new_scores[:, :, 1:].permute(2, 0, 1)  # (C-1, T, Nb)
        cls_mask = (cls_scores > 0) & omask[None]
        with record_function("fused.seq_nms"):
            final_scores, path_ids = seq_nms_batch(
                oboxes, cls_scores, cls_mask, cfg.link_thresh, cfg.suppress_thresh,
                max_paths=cfg.max_paths, rescore=cfg.link_rescore,
            )
        return FusedOutput(
            oboxes, new_scores, omask, final_scores, path_ids, tb, tc, ta, n_tracks, stats,
        )


def make_fused_pipeline(det_model, trk_model, trk_cfg, cfg: FusedConfig) -> FusedPipeline:
    """Returns fn(frames_u8 (T,H,W,3), rois (T,R,4), t_valid=None, roi_mask=None).

    ``T`` must be a multiple of ``cfg.detect_batch`` as in the JAX package
    (see :func:`pad_snippet`); tensors stay on the device they arrive on."""
    return FusedPipeline(det_model, trk_model, trk_cfg, cfg)


class ShardedPipeline:
    """The fused pipeline over a batch of snippets split along the mesh's
    ``data`` dim; see :func:`make_sharded_pipeline`."""

    def __init__(self, pipe: FusedPipeline, mesh):
        self.pipe = pipe
        self.mesh = mesh

    @torch.no_grad()
    def __call__(self, frames, rois, t_valid=None, roi_mask=None) -> FusedOutput:
        """frames (V, T, H, W, 3) uint8, rois (V, T, R, 4); optional t_valid
        (V,) and roi_mask (V, T, R) → :class:`FusedOutput` with a leading V
        on every field (``n_tracks`` (V,))."""
        V = frames.shape[0]
        r, d = data_rank_size(self.mesh)
        if V % d:
            raise ValueError(f"{V} snippets not divisible by the mesh's data size {d}")
        n = V // d
        outs = [
            self.pipe(frames[v], rois[v], None if t_valid is None else t_valid[v],
                      None if roi_mask is None else roi_mask[v])
            for v in range(r * n, (r + 1) * n)
        ]
        local = [torch.stack(f) for f in zip(*outs)]
        group = self.mesh.get_group("data")
        fields = []
        for x in local:
            # gathered as uint8 where bool: not every backend takes bool
            y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
            parts = [torch.empty_like(y) for _ in range(d)]
            dist.all_gather(parts, y, group=group)
            fields.append(torch.cat(parts).to(x.dtype))
        return FusedOutput(*fields)


def make_sharded_pipeline(det_model, trk_model, trk_cfg, cfg: FusedConfig, mesh
                          ) -> ShardedPipeline:
    """Data-parallel fused pipeline: snippets split along the mesh's ``data`` dim.

    Returns fn(frames (V, T, H, W, 3), rois (V, T, R, 4)) → ``FusedOutput``
    with a leading V, on every rank; V must divide by the data size. The
    models must hold the same weights on every rank (``dist.replicate``).
    Each rank runs its contiguous block of snippets one after another
    through :class:`FusedPipeline` (per-video state never crosses ranks),
    then the V outputs are gathered onto every rank. The JAX program vmaps
    a rank's block as one program; a rank's videos here equal single calls
    bit for bit."""
    return ShardedPipeline(FusedPipeline(det_model, trk_model, trk_cfg, cfg), mesh)


def pad_snippet(frames_u8, rois, bucket: int = 32):
    """Pad a (T, ...) numpy snippet to the next T bucket (repeat last frame).

    Returns (frames_p, rois_p, t_valid)."""
    T = frames_u8.shape[0]
    Tp = max(((T + bucket - 1) // bucket) * bucket, bucket)
    if Tp == T:
        return frames_u8, rois, T
    fpad = np.repeat(frames_u8[-1:], Tp - T, axis=0)
    rpad = np.zeros((Tp - T,) + rois.shape[1:], rois.dtype)
    return np.concatenate([frames_u8, fpad], axis=0), np.concatenate([rois, rpad], axis=0), T


def fused_to_protos(out: FusedOutput, frame_ids, video: str, class_names=None,
                    min_score: float = 0.0):
    """FusedOutput → (final det_proto, tubelets track_proto), as the JAX function."""
    from vdetlib_tpu_torch.protos.arrays import arrays_to_det_proto
    from vdetlib_tpu_torch.video.link import tubelets_from_path_ids

    boxes = out.det_boxes.cpu().numpy()
    mask = out.det_mask.cpu().numpy()
    final = out.final_scores.cpu().numpy()  # (C-1, T, Nb)
    path_ids = out.path_ids.cpu().numpy()
    C = out.det_scores.shape[-1]
    T, Nb = mask.shape
    new_scores = np.zeros((T, Nb, C), np.float32)
    new_scores[:, :, 1:] = np.moveaxis(np.maximum(final, 0.0), 0, 2)
    det_proto = arrays_to_det_proto(
        boxes, new_scores, mask, frame_ids, video,
        class_names=class_names, score_thresh=min_score,
    )
    track_proto = tubelets_from_path_ids(boxes, final, path_ids, frame_ids, video, first_class=1)
    return det_proto, track_proto
