"""The stream engine's emissions and its tracker steps in plain PyTorch.

:func:`stream_emissions` is a frozen copy of the port's per-chunk detection
path (``video/stream.py``: detection, per-frame per-class NMS, MGP with a
one-frame halo and its NMS dedup) and of the video-end seq-NMS, carried
chunk to chunk as the engine carries it. The emissions do not depend on the
tracker, so they are compared whole.

The online tracker's rollouts are chaotic (a last-bit difference in a
template grows into pixels of drift within tens of frames), so its tracks
are judged step by step from the program's own states: :func:`track_steps`
takes each emitted track's seed (its box and frame), extracts the template
from the reference's own features, and recomputes every recorded step from
the box the program held one step before, forward after the seed and
backward before it (the backtrack).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.boxes import shift_boxes
from portbench.reference.flow import FLOW_PRESET_POOL, flow_video, mean_flow_in_boxes
from portbench.reference.fused import detect_step
from portbench.reference.nets import extract_template, ncc_update, tracker_features
from portbench.reference.nms import batched_nms
from portbench.reference.seq_nms import seq_nms_batch


def _mgp_chunk(frames_ext, rois, cls_scores, keep, prev_rois, prev_scores, prev_keep,
               decay: float, p_flow, preset: str):
    """One chunk of MGP (t±1, one-frame forward halo) → boxes (Tc, 3R, 4),
    scores (Tc, C-1, 3R), valid (Tc, C-1, 3R) in slot blocks [native, fwd, bwd]."""
    R = rois.shape[1]
    coord_scale = 1.0 / FLOW_PRESET_POOL[preset]
    fwd = flow_video(frames_ext, p_flow, preset=preset)
    bwd = flow_video(frames_ext.flip(0), p_flow, preset=preset).flip(0)
    src_boxes = torch.cat([prev_rois[None], rois[:-1]])
    src_scores = torch.cat([prev_scores[None], cls_scores[:-1]])
    src_keep = torch.cat([prev_keep[None], keep[:-1]])
    fwd_boxes = shift_boxes(src_boxes, mean_flow_in_boxes(fwd, src_boxes * coord_scale,
                                                          src_keep.any(1)))
    nsrc_boxes = torch.cat([rois[1:], rois.new_zeros((1, R, 4))])
    nsrc_scores = torch.cat([cls_scores[1:], torch.zeros_like(cls_scores[:1])])
    nsrc_keep = torch.cat([keep[1:], torch.zeros_like(keep[:1])])
    bflow = torch.cat([bwd[1:], torch.zeros_like(bwd[:1])])
    bwd_boxes = shift_boxes(nsrc_boxes, mean_flow_in_boxes(bflow, nsrc_boxes * coord_scale,
                                                           nsrc_keep.any(1)))
    m_boxes = torch.cat([rois, fwd_boxes, bwd_boxes], dim=1)
    m_scores = torch.cat([cls_scores, src_scores * decay, nsrc_scores * decay], dim=2)
    m_valid = torch.cat([keep, src_keep, nsrc_keep], dim=2)
    return m_boxes, m_scores, m_valid


@torch.no_grad()
def stream_emissions(det, opts, frames: np.ndarray, rois: np.ndarray):
    """The emissions of one video streamed in ``opts.chunk``-frame chunks and
    the video-end linking → dict of numpy ``boxes`` (T, 3R, 4), ``scores``
    (T, C-1, 3R), ``keep`` (T, C-1, 3R) and ``seq_scores`` (C-1, T, 3R).
    ``opts`` is a configuration's ``stream`` mapping (attribute access)."""
    dev = next(det.parameters()).device
    T = frames.shape[0]
    R, C, L = opts.max_rois, opts.num_classes, opts.chunk
    prev_rois = torch.zeros((R, 4), device=dev)
    prev_scores = torch.zeros((C - 1, R), device=dev)
    prev_keep = torch.zeros((C - 1, R), dtype=torch.bool, device=dev)
    halo = None
    all_boxes, all_scores, all_keep = [], [], []
    for t0 in range(0, T, L):
        chunk = frames[t0:t0 + L]
        Tc = chunk.shape[0]
        r = np.zeros((L, R, 4), np.float32)
        r[:Tc] = rois[t0:t0 + Tc]
        if Tc < L:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], L - Tc, 0)])
        fr = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
        rt = torch.from_numpy(r).to(dev)
        if halo is None:
            halo = fr[0]
        probs, boxes = detect_step(det, fr, rt)
        cls_scores = probs[:, :, 1:].transpose(1, 2).contiguous()
        cls_boxes = boxes[:, :, 1:, :].transpose(1, 2)
        keep = batched_nms(cls_boxes, cls_scores, cls_scores > 0.01, opts.nms_thresh)
        m_boxes, m_scores, m_valid = _mgp_chunk(
            torch.cat([halo[None], fr]), rt, cls_scores, keep, prev_rois, prev_scores,
            prev_keep, opts.mgp_decay, det.prec.flow, opts.flow_preset)
        m_keep = batched_nms(m_boxes[:, None].expand((L, C - 1) + m_boxes.shape[1:]), m_scores,
                             m_valid & (m_scores > 0), opts.nms_thresh)
        last = Tc - 1
        prev_rois, prev_scores, prev_keep = rt[last], cls_scores[last], keep[last]
        halo = fr[last]
        all_boxes.append(m_boxes[:Tc].cpu().numpy())
        all_scores.append(m_scores[:Tc].cpu().numpy())
        all_keep.append(m_keep[:Tc].cpu().numpy())
    boxes = np.concatenate(all_boxes)
    scores = np.concatenate(all_scores)
    keep = np.concatenate(all_keep)
    seq, _ = seq_nms_batch(
        torch.from_numpy(boxes).to(dev),
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(scores, 1, 0))).to(dev),
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(keep, 1, 0))).to(dev),
        opts.link_thresh, opts.suppress_thresh, max_paths=opts.max_paths)
    return {"boxes": boxes, "scores": scores, "keep": keep, "seq_scores": seq.cpu().numpy()}


@torch.no_grad()
def video_features(trk, frames: np.ndarray, batch: int):
    """Tracker features of every frame, (T, h, w, C), in ``batch``-frame calls."""
    dev = next(trk.parameters()).device
    return torch.cat([tracker_features(trk, torch.from_numpy(frames[i:i + batch]).to(dev))
                      for i in range(0, frames.shape[0], batch)])


@torch.no_grad()
def track_steps(trk, feats, steps, lanes: int = 256):
    """Recompute tracker steps from the program's states.

    ``steps``: list of (seed frame, seed box, frame, box before the step),
    one per recorded step; each step is an NCC update of the box before it
    at ``frame``'s features with the template of the seed box at the seed
    frame → (boxes (S, 4), peaks (S,)) numpy."""
    dev = feats.device
    out_b, out_p = [], []
    for i in range(0, len(steps), lanes):
        part = steps[i:i + lanes]
        ts = torch.tensor([s[0] for s in part], device=dev)
        sb = torch.tensor(np.stack([s[1] for s in part]), dtype=torch.float32, device=dev)
        tf = torch.tensor([s[2] for s in part], device=dev)
        pb = torch.tensor(np.stack([s[3] for s in part]), dtype=torch.float32, device=dev)
        tpl = extract_template(feats[ts], sb, trk.arch, trk.prec)
        nb, pk = ncc_update(feats[tf], pb[:, None], tpl[:, None], trk.arch, trk.prec)
        out_b.append(nb[:, 0].cpu().numpy())
        out_p.append(pk[:, 0].cpu().numpy())
    if not out_b:
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    return np.concatenate(out_b), np.concatenate(out_p)
