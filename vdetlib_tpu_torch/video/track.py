"""Batched correlation tracking — counterpart of ``vdetlib_tpu/video/track.py``.

Dense tracker features are computed once for all frames and shared by every
anchor. :func:`track_batch` tracks A anchors forward and backward in ONE
scan of T steps: step i advances the forward lanes at frame i and the
backward lanes at frame T-1-i (the JAX package's folded scan). The scan is
``kernels/track_scan.py``: kernel F on the card (one launch), its plain
version (a fixed-trip loop of tensor ops, no host synchronisation per step)
on the CPU and for the options outside the kernel's contract: several
scales, EMA templates (``TrackerConfig.template_eta``) and detection
snapping (:func:`snap_to_dets`).

:func:`track_from_det` is the staged tracking stage: greedy anchor rounds
on the host over a det_proto, each round tracked by :func:`track_batch`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.kernels.track_scan import (
    ema_templates,
    kernel_takes,
    ncc_update,
    snap_to_dets,
    track_scan_kernel,
    track_scan_plain,
)
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, extract_template
from vdetlib_tpu_torch.protos.accessors import tracks_proto_from_boxes
from vdetlib_tpu_torch.utils.common import iou as np_iou
from vdetlib_tpu_torch.utils.log import StageMetrics

__all__ = ["TrackOptions", "_candidate_dets", "_track_one_direction", "ncc_update",
           "snap_to_dets", "track_batch", "track_from_det", "tracker_features"]


@dataclass(frozen=True)
class TrackOptions:
    """Same fields and defaults as the JAX ``TrackOptions``."""

    max_tracks: int = 32
    anchors_per_round: int = 8
    anchor_thresh: float = 0.3  # min det score to seed a track
    conf_thresh: float = 0.5  # tracker termination confidence
    cover_thresh: float = 0.5  # det covered if IoU with a track box exceeds this
    batch_size: int = 16  # frames per feature-extraction batch
    image_hw: Optional[tuple] = None  # None = native frame size
    # detection snapping (0.0 = off): after each NCC update, blend the tracked
    # box toward the best same-frame detection overlapping it (IoU > snap_iou)
    # among the anchor candidates
    snap_weight: float = 0.0
    snap_iou: float = 0.5
    # advance the NCC scan every s-th frame only, interpolating the skipped
    # frames (track_batch docstring); the tracker features are computed for
    # the sampled frames only
    frame_stride: int = 2


def tracker_features(model, frames_u8):
    """(B, H, W, 3) uint8 → (B, h, w, C) dense tracker features."""
    x = frames_u8.float() / 255.0 - 0.5
    return model(x)


def _track_one_direction(feats, anchor_t, anchor_box, template, cfg: TrackerConfig,
                         conf_thresh: float, reverse: bool, snap=None, snap_iou: float = 0.5,
                         snap_weight: float = 0.5):
    """Scan the full frame axis for L anchors, one direction.

    The JAX function scans one anchor and is vmapped over anchors; here the L
    lanes share each step's frame, so one :func:`ncc_update` serves them all.
    Detection snapping and EMA templates follow the folded scan's rule
    (``kernels/track_scan.py::track_scan_plain``).

    Args:
      feats: (T, h, w, C) tracker features.
      anchor_t: (L,) int frame index of each anchor; anchor_box: (L, 4) pixel
        boxes at the anchor frames; template: (L, P, P, C) normalized;
      snap: None, or (det_boxes (T, N, 4), det_scores (T, N), valid (T, N)).
    Returns:
      boxes (L, T, 4), conf (L, T), alive (L, T) — entries before the anchor
      (in scan direction) are dead; the anchor frame is alive with conf 1.
    """
    T = feats.shape[0]
    L = anchor_t.shape[0]
    dev = feats.device
    adapt = cfg.template_eta > 0.0
    box = torch.zeros((L, 4), dtype=torch.float32, device=dev)
    alive = torch.zeros((L,), dtype=torch.bool, device=dev)
    tpl = template[None]
    out_b, out_c, out_a = [], [], []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        started = anchor_t == t
        box = torch.where(started[:, None], anchor_box, box)
        alive = alive | started
        if adapt:
            tpl = torch.where(started[None, :, None, None, None], template[None], tpl)
        new_box, peak = ncc_update(feats[t][None], box[None], tpl, cfg)
        new_box, peak = new_box[0], peak[0]
        track_now = alive & ~started
        ok = peak > conf_thresh
        new_alive = torch.where(track_now, alive & ok, alive)
        new_box = torch.where((track_now & ok)[:, None], new_box, box)
        if snap is not None:
            snapped, _ = snap_to_dets(new_box, snap[0][t], snap[1][t], snap[2][t], snap_iou,
                                      snap_weight)
            new_box = torch.where((track_now & ok)[:, None], snapped, new_box)
        out_b.append(new_box)
        out_c.append(torch.where(started, torch.ones_like(peak), peak))
        out_a.append(started | new_alive)
        if adapt:
            upd = (track_now & ok & (peak > cfg.template_update_conf))[None]
            tpl = ema_templates(tpl, extract_template(feats[t][None], new_box[None], cfg), upd,
                                cfg)
        box, alive = new_box, new_alive
    if reverse:
        out_b, out_c, out_a = out_b[::-1], out_c[::-1], out_a[::-1]
    return torch.stack(out_b, 1), torch.stack(out_c, 1), torch.stack(out_a, 1)


def track_batch(cfg: TrackerConfig, feats, anchor_ts, anchor_boxes, conf_thresh: float,
                snap=None, snap_iou: float = 0.5, snap_weight: float = 0.5,
                frame_stride: int = 1, feats_strided: bool = False,
                full_t: int | None = None, valid_t=None):
    """Track A anchors forward+backward over (T, h, w, C) features.

    Returns boxes (A, T, 4), conf (A, T), alive (A, T); the anchor frame is
    alive with conf 1.0; dead frames carry the last live box (masked out).

    ``frame_stride`` s > 1: the loop advances on every s-th frame only;
    skipped frames get boxes/conf interpolated between their sampled
    neighbours (alive iff both are), anchors snap to ``(t + s//2) // s``
    clamped to the last sampled real frame, and each anchor's ORIGINAL frame
    is re-asserted (anchor box, conf 1.0, alive). ``feats_strided=True``:
    ``feats`` already holds only every s-th frame (ceil(full_t/s) rows).
    ``valid_t`` (bucket-padded T): the count of REAL frames; the anchor snap
    and the interpolation neighbour clamp to the last real sampled frame.
    ``snap`` (det_boxes (T, N, 4), det_scores (T, N), valid (T, N)), in
    FULL-frame indexing at every stride: after each confident update a
    lane's box blends toward its best same-frame detection
    (:func:`snap_to_dets`, ``snap_iou``, ``snap_weight``).

    The stride-1 scan is chosen from the configuration before anything runs,
    never after a failure: a ``cfg`` in kernel F's contract
    (``kernels.track_scan.kernel_takes``: one scale, frozen templates) with
    no ``snap`` goes to ``track_scan_kernel`` (kernel F on a CUDA tensor,
    the plain loop on a CPU one); every other configuration (several
    scales, EMA templates, snapping) runs ``track_scan_plain``, as the JAX
    package runs it through its XLA scan.
    """
    if frame_stride > 1:
        s = int(frame_stride)
        if feats_strided:
            if full_t is None:
                raise ValueError("feats_strided=True requires full_t")
            T = int(full_t)
            feats_s = feats
            if feats_s.shape[0] != -(-T // s):
                raise ValueError(
                    f"pre-strided feats have {feats_s.shape[0]} rows, expected ceil({T}/{s})"
                )
        else:
            T = feats.shape[0]
            feats_s = feats[::s]
        Ts = feats_s.shape[0]
        dev = anchor_ts.device
        if valid_t is None:
            last_sample = torch.tensor(Ts - 1, device=dev)
        else:
            last_sample = torch.clamp(torch.as_tensor(valid_t, device=dev) - 1, min=0) // s
        zero = torch.zeros((), dtype=anchor_ts.dtype, device=dev)
        anchor_ts_s = torch.clamp((anchor_ts + s // 2) // s, zero, last_sample.to(anchor_ts.dtype))
        snap_s = None if snap is None else tuple(a[::s] for a in snap)
        boxes_s, conf_s, alive_s = track_batch(
            cfg, feats_s, anchor_ts_s, anchor_boxes, conf_thresh, snap=snap_s,
            snap_iou=snap_iou, snap_weight=snap_weight, frame_stride=1,
        )
        t_full = torch.arange(T, device=dev)
        i0 = t_full // s
        i1 = torch.minimum(i0 + 1, last_sample.to(i0.dtype))
        f = ((t_full - i0 * s).float() / s)[None, :, None]
        b0, b1 = boxes_s[:, i0], boxes_s[:, i1]
        boxes = (1.0 - f) * b0 + f * b1
        exact = (t_full % s == 0)[None, :]
        a0, a1 = alive_s[:, i0], alive_s[:, i1]
        alive = torch.where(exact, a0, a0 & a1)
        boxes = torch.where(exact[..., None], b0, boxes)
        c0, c1 = conf_s[:, i0], conf_s[:, i1]
        conf = torch.where(exact, c0, (1.0 - f[..., 0]) * c0 + f[..., 0] * c1)
        # re-assert the anchor at its ORIGINAL frame
        lane = torch.arange(anchor_ts.shape[0], device=dev)
        boxes = boxes.index_put((lane, anchor_ts), anchor_boxes)
        conf = conf.index_put((lane, anchor_ts), torch.ones_like(anchor_boxes[:, 0]))
        alive = alive.index_put((lane, anchor_ts), torch.ones_like(alive[:, 0]))
        return boxes, conf, alive

    if feats_strided:
        raise ValueError("feats_strided requires frame_stride > 1")
    T = feats.shape[0]
    templates = extract_template(feats[anchor_ts], anchor_boxes, cfg)  # (A, P, P, C)
    if kernel_takes(cfg) and snap is None:
        outs = track_scan_kernel(feats, anchor_ts, anchor_boxes, templates, cfg, conf_thresh)
    else:
        outs = track_scan_plain(feats, anchor_ts, anchor_boxes, templates, cfg, conf_thresh,
                                snap=snap, snap_iou=snap_iou, snap_weight=snap_weight)
    fb, fc, fa, bb, bc, ba = (v.transpose(0, 1) for v in outs)  # each (A, T, ...)
    use_f = torch.arange(T, device=feats.device)[None, :] >= anchor_ts[:, None]  # (A, T)
    boxes = torch.where(use_f[..., None], fb, bb)
    conf = torch.where(use_f, fc, bc)
    alive = torch.where(use_f, fa, ba)
    return boxes, conf, alive


def _candidate_dets(det_proto, frame_index, min_score):
    """Flatten det_proto → (frames_idx[N], boxes[N,4], scores[N]) numpy."""
    fr, bx, sc = [], [], []
    for d in det_proto["detections"]:
        t = frame_index.get(int(d["frame"]))
        if t is None:
            continue
        best = max((float(s["score"]) for s in d["scores"]), default=0.0)
        if best < min_score:
            continue
        fr.append(t)
        bx.append(d["bbox"])
        sc.append(best)
    if not fr:
        return np.zeros(0, int), np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    return np.asarray(fr), np.asarray(bx, np.float32), np.asarray(sc, np.float32)


@torch.no_grad()
def track_from_det(model, vid_proto: dict, det_proto: dict, cfg: TrackerConfig = TrackerConfig(),
                   opts: TrackOptions = TrackOptions(), frames_u8: Optional[np.ndarray] = None) -> dict:
    """Full tubelet-proposal stage: vid_proto + det_proto → track_proto.

    The JAX function's stage, on the device of ``model``: tracker features of
    the sampled frames in batches of ``opts.batch_size`` (the tail padded by
    repetition), then greedy rounds on the host: pick up to
    ``anchors_per_round`` mutually non-overlapping top-score uncovered
    candidates (best score >= ``anchor_thresh``), track them in one
    :func:`track_batch` call padded to a static A, and mark every candidate a
    live track box covers (IoU > ``cover_thresh``) until ``max_tracks`` or
    full coverage. With ``opts.snap_weight`` > 0 the tracks snap to the
    candidate set (best score >= ``anchor_thresh``), per frame in arrays
    padded to a multiple of 8 slots, as in the JAX stage. ``frames_u8``
    (T, H, W, 3) uint8 skips the frame files (frames at ``opts.image_hw``
    when it is set)."""
    metrics = StageMetrics("track")
    frame_ids = [f["frame"] for f in vid_proto["frames"]]
    frame_index = {f: i for i, f in enumerate(frame_ids)}
    T = len(frame_ids)
    dev = next(model.parameters()).device

    # --- frame features (device, batched once), for the sampled frames only
    loader = FrameLoader(vid_proto, target_hw=opts.image_hw, frames=frames_u8)
    frames_u8 = np.stack([img for _, img, _ in loader.iter_frames()])
    loader.close()
    stride = int(opts.frame_stride)
    feat_src = frames_u8[::stride] if stride > 1 else frames_u8
    B = opts.batch_size
    feats_list = []
    with record_function("track.features"):
        for s in range(0, len(feat_src), B):
            chunk = torch.from_numpy(np.ascontiguousarray(feat_src[s:s + B])).to(dev)
            pad = B - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand((pad,) + chunk.shape[1:])])
            feats_list.append(tracker_features(model, chunk)[:B - pad])
        feats = torch.cat(feats_list)

    # --- greedy anchor rounds (host)
    cand_t, cand_boxes, cand_scores = _candidate_dets(det_proto, frame_index, opts.anchor_thresh)
    snap = None
    if opts.snap_weight > 0.0 and len(cand_t):
        counts = np.bincount(cand_t, minlength=T)
        npad = max(8, int(-(-counts.max() // 8) * 8))
        sb = np.zeros((T, npad, 4), np.float32)
        ss = np.zeros((T, npad), np.float32)
        sv = np.zeros((T, npad), bool)
        fill = np.zeros(T, np.int64)
        for i, t in enumerate(cand_t):
            sb[t, fill[t]], ss[t, fill[t]], sv[t, fill[t]] = cand_boxes[i], cand_scores[i], True
            fill[t] += 1
        snap = tuple(torch.from_numpy(a).to(dev) for a in (sb, ss, sv))
    covered = np.zeros(len(cand_t), dtype=bool)
    all_boxes, all_conf, all_alive, all_anchor = [], [], [], []
    while len(all_boxes) < opts.max_tracks and not covered.all():
        # pick up to A mutually non-overlapping top candidates
        order = np.argsort(-cand_scores, kind="stable")
        picked = []
        for i in order:
            if covered[i]:
                continue
            clash = False
            for j in picked:
                if cand_t[j] == cand_t[i] and np_iou(
                    cand_boxes[i:i + 1], cand_boxes[j:j + 1]
                )[0, 0] > opts.cover_thresh:
                    clash = True
                    break
            if not clash:
                picked.append(int(i))
            if len(picked) == min(opts.anchors_per_round, opts.max_tracks - len(all_boxes)):
                break
        if not picked:
            break
        A = opts.anchors_per_round
        sel = (picked + [picked[-1]] * A)[:A]  # pad to static A
        with record_function("track.scan"):
            boxes, conf, alive = track_batch(
                cfg, feats, torch.from_numpy(np.asarray(cand_t)[sel]).to(dev),
                torch.from_numpy(cand_boxes[sel]).to(dev), opts.conf_thresh, snap=snap,
                snap_iou=opts.snap_iou, snap_weight=opts.snap_weight,
                frame_stride=opts.frame_stride, feats_strided=stride > 1,
                full_t=T if stride > 1 else None,
            )
            boxes, conf, alive = (x.cpu().numpy() for x in (boxes, conf, alive))
        for k, i in enumerate(picked):
            all_boxes.append(boxes[k])
            all_conf.append(conf[k])
            all_alive.append(alive[k])
            all_anchor.append(int(frame_ids[cand_t[i]]))
            covered[i] = True
            # suppress candidates covered by this track
            for t in range(T):
                if not alive[k, t]:
                    continue
                same_t = cand_t == t
                if not same_t.any():
                    continue
                m = np_iou(boxes[k, t:t + 1], cand_boxes[same_t])[0]
                idx = np.nonzero(same_t)[0][m > opts.cover_thresh]
                covered[idx] = True

    per_track = [
        [(frame_ids[t], boxes[t], float(conf[t])) for t in range(T) if alive[t]]
        for boxes, conf, alive in zip(all_boxes, all_conf, all_alive)
    ]
    proto = tracks_proto_from_boxes(
        per_track, vid_proto["video"], method="correlation_tracker", anchors=all_anchor
    )
    metrics.set("frames", T)
    metrics.set("tracks", len(proto["tracks"]))
    metrics.finish()
    return proto
