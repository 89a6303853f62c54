"""Streaming (online, chunked) video processing — counterpart of
``vdetlib_tpu/video/stream.py``, both engines.

The frame axis is processed in fixed-size chunks with carried state across
chunk boundaries. Per chunk:

- detection + per-frame per-class NMS (``batched_nms``: kernel C on a card);
- motion-guided propagation with a one-frame halo: flow over [previous
  chunk's last frame] + chunk (kernel A), detections hop t→t+1 (across the
  boundary through the carried last-frame detections) and t→t-1 inside the
  chunk, then per-frame per-class NMS dedups the union (``batched_nms`` at
  N = 3R: kernel B with one group on a card). The backward hop from the next
  chunk's first frame is dropped (the future is unknown at emission time);
- online tracking: the carried track slots (box, alive, template) advance
  over the chunk (:func:`track_chunk`, or :func:`track_chunk_strided` at
  ``track_stride`` 2), and new tracks are seeded greedily from the chunk's
  top uncovered detections;
- backward re-tracking of the fresh seeds over [previous chunk + current
  chunk] (:func:`backtrack_seeds`).

Two engines compute the same results bit for bit. ``engine="fused"`` runs a
chunk in one call of the step that :func:`make_stream_chunk_fn` builds: the
greedy seeding is a fixed-trip loop of ``track_slots`` self-gated steps, so
the step never waits on the card, and every host output travels in ONE
packed float32 tensor per chunk. ``engine="host"`` calls the stages one by
one and seeds on the host in numpy, as the JAX host engine does; it is the
reference the fused engine is held to. Both call the same stage functions
and share the host bookkeeping of track ids and segments. After the last
chunk, seq-NMS linking runs once over the collected boxes and scores.

With EMA templates (``TrackerConfig.template_eta`` > 0) the slot templates
adapt inside :func:`track_chunk` and the adapted ones are carried to the
next chunk, in both engines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from vdetlib_tpu_torch.geometry.boxes import pairwise_iou, shift_boxes
from vdetlib_tpu_torch.kernels.flow import flow_coord_scale, flow_video, mean_flow_in_boxes
from vdetlib_tpu_torch.kernels.nms import batched_nms
from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_batch
from vdetlib_tpu_torch.kernels.track_scan import ema_templates
from vdetlib_tpu_torch.nn.tracker_net import extract_template
from vdetlib_tpu_torch.utils.common import iou as np_iou
from vdetlib_tpu_torch.utils.log import StageMetrics
from vdetlib_tpu_torch.video.detect import _detect_step
from vdetlib_tpu_torch.video.link import path_counts
from vdetlib_tpu_torch.video.track import _track_one_direction, ncc_update, tracker_features

ENGINES = ("fused", "host")


@dataclass(frozen=True)
class StreamOptions:
    """Same fields and defaults as the JAX ``StreamOptions``."""

    engine: str = "fused"  # "fused" (one step a chunk) | "host" (stage by stage)
    chunk: int = 32  # frames per step
    max_rois: int = 64
    num_classes: int = 31
    track_slots: int = 16  # live track capacity (carried across chunks)
    seed_thresh: float = 0.4  # min det score to seed a new track
    cover_thresh: float = 0.5
    conf_thresh: float = 0.3  # track termination
    nms_thresh: float = 0.3
    link_thresh: float = 0.5
    suppress_thresh: float = 0.3
    max_paths: int = 64
    # motion-guided propagation (t±1, one-frame halo across chunks)
    mgp: bool = True
    mgp_decay: float = 0.9
    flow_preset: str = "fastest"
    # backward re-tracking of fresh seeds over [prev chunk + current chunk]
    backtrack: bool = True
    # 1 (frame-exact) or 2: the tracker scan and its features run on every
    # 2nd frame, the skipped frames interpolate, and a full chunk's last
    # frame is emitted one chunk late as the boundary fill
    track_stride: int = 1


class StreamCarry(NamedTuple):
    """State carried from one chunk to the next, on the device."""

    templates: torch.Tensor  # (A, P, P, C) slot templates
    boxes: torch.Tensor  # (A, 4) slot boxes
    alive: torch.Tensor  # (A,) slot alive
    prev_rois: torch.Tensor  # (R, 4) previous chunk's last-frame proposals
    prev_scores: torch.Tensor  # (C-1, R) ... its per-class scores
    prev_keep: torch.Tensor  # (C-1, R) ... its NMS survivors
    prev_feats: torch.Tensor | None  # previous chunk's tracker features (None at start)
    # the previous chunk's scan-end snapshot, BEFORE seeding: the left
    # neighbour of the boundary fill at track_stride 2. A slot seeded in that
    # chunk is not alive here, so the fill never lands on its new occupant.
    bnd_box: torch.Tensor  # (A, 4)
    bnd_conf: torch.Tensor  # (A,)
    bnd_alive: torch.Tensor  # (A,)


def init_carry(opts: StreamOptions, trk_cfg, device) -> StreamCarry:
    A, R, C = opts.track_slots, opts.max_rois, opts.num_classes
    P, Cf = trk_cfg.template_pool, trk_cfg.out_features
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return StreamCarry(
        torch.zeros((A, P, P, Cf), **f32), torch.zeros((A, 4), **f32), torch.zeros((A,), **b),
        torch.zeros((R, 4), **f32), torch.zeros((C - 1, R), **f32), torch.zeros((C - 1, R), **b),
        None,
        torch.zeros((A, 4), **f32), torch.zeros((A,), **f32), torch.zeros((A,), **b),
    )


def _stride(opts: StreamOptions) -> int:
    """The track stride, checked as the JAX engines check it."""
    s = int(opts.track_stride)
    if s not in (1, 2) or opts.chunk % s:
        raise ValueError("streaming track_stride supports 1 and 2; chunk must divide")
    return s


def _take(x, i):
    """x[i] for a 0-d index tensor ``i`` without a host synchronisation
    (indexing with a 0-d tensor would read it back)."""
    return x.index_select(0, i.reshape(1))[0]


def _extract_templates_core(feats, seed_ti, seed_boxes, cfg):
    """Gather each seed's frame and extract its template: (A,) frames, (A, 4)
    boxes → (A, P, P, C). Both engines call it with A lanes, so their
    templates agree bit for bit."""
    return extract_template(feats[seed_ti], seed_boxes, cfg)


def track_chunk(cfg, feats, templates, boxes0, alive0, conf_thresh: float):
    """Advance all track slots over one chunk of features.

    Args:
      feats: (Tc, h, w, C); templates: (A, P, P, C); boxes0: (A, 4);
      alive0: (A,) bool — state carried from the previous chunk.
    Returns:
      boxes (A, Tc, 4), conf (A, Tc), alive (A, Tc), and the carry
      (boxes_end (A, 4), alive_end (A,), templates_end). ``templates_end``
      is ``templates`` unless ``cfg.template_eta`` > 0: then a slot alive
      after a step whose peak exceeds ``template_update_conf`` moves its
      template toward the one at its new box (the batch tracker's EMA rule,
      ``kernels/track_scan.py::ema_templates``). Both engines call this
      function, which keeps them equal bit for bit.
    """
    adapt = cfg.template_eta > 0.0
    box, alive = boxes0, alive0
    tpl = templates[None]
    out_b, out_c, out_a = [], [], []
    for t in range(feats.shape[0]):
        new_box, peak = ncc_update(feats[t][None], box[None], tpl, cfg)
        new_box, peak = new_box[0], peak[0]
        alive = alive & (peak > conf_thresh)
        box = torch.where(alive[:, None], new_box, box)
        out_b.append(box)
        out_c.append(peak)
        out_a.append(alive)
        if adapt:
            upd = (alive & (peak > cfg.template_update_conf))[None]
            tpl = ema_templates(tpl, extract_template(feats[t][None], box[None], cfg), upd,
                                cfg)
    return (torch.stack(out_b, 1), torch.stack(out_c, 1), torch.stack(out_a, 1),
            box, alive, tpl[0] if adapt else templates)


def track_chunk_strided(cfg, feats_s, templates, boxes0, alive0, bnd_box, bnd_conf, bnd_alive,
                        conf_thresh: float, stride: int, chunk_len: int):
    """The slot advance at ``track_stride`` 2, upsampled to every frame.

    :func:`track_chunk` runs once per sample (every ``stride``-th frame);
    a skipped frame takes the linear interpolation of its two samples (alive
    only where both are), an exact sample keeps its value, and the chunk's
    trailing skipped frame holds the last sample: its true interpolation
    needs the next chunk's first sample, so this function also returns the
    BOUNDARY FILL of the previous chunk's last frame. As in JAX, no
    ``tc_valid`` clamp: on a partial final chunk the tail frames interpolate
    toward a padded sample.

    Args:
      feats_s: (Ts, h, w, C) features of every stride-th chunk frame
        (Ts = chunk_len // stride).
      bnd_box/bnd_conf/bnd_alive: the previous chunk's scan-end snapshot
        (before seeding) — the left neighbour of the boundary frame.
    Returns:
      (boxes (A, chunk_len, 4), conf (A, chunk_len), alive (A, chunk_len),
      box_end (A, 4), conf_end (A,), alive_end (A,), templates_end,
      bfill_box (A, 4), bfill_conf (A,), bfill_alive (A,)).
    """
    if stride != 2:
        raise ValueError("streaming track_stride supports 1 and 2 only")
    if chunk_len % stride:
        raise ValueError("chunk must be a multiple of track_stride")
    s = stride
    boxes_s, conf_s, alive_s, box_end, alive_end, tpl_end = track_chunk(
        cfg, feats_s, templates, boxes0, alive0, conf_thresh
    )
    Ts = feats_s.shape[0]
    t_full = torch.arange(chunk_len, device=feats_s.device)
    i0 = t_full // s
    i1 = torch.clamp(i0 + 1, max=Ts - 1)
    # float32 as the JAX function computes it, so that the interpolated
    # boxes equal JAX's to the last bit on the same samples
    f = ((t_full - i0 * s).float() / s)[None, :, None]
    exact = (t_full % s == 0)[None, :]
    b0, b1 = boxes_s[:, i0], boxes_s[:, i1]
    boxes = torch.where(exact[..., None], b0, (1.0 - f) * b0 + f * b1)
    a0, a1 = alive_s[:, i0], alive_s[:, i1]
    alive = torch.where(exact, a0, a0 & a1)
    c0, c1 = conf_s[:, i0], conf_s[:, i1]
    conf = torch.where(exact, c0, (1.0 - f[..., 0]) * c0 + f[..., 0] * c1)
    fb = 1.0 / s  # exact in float32, as JAX's jnp.float32(1.0 / s)
    bfill_box = (1.0 - fb) * bnd_box + fb * boxes_s[:, 0]
    bfill_conf = (1.0 - fb) * bnd_conf + fb * conf_s[:, 0]
    bfill_alive = bnd_alive & alive_s[:, 0]
    return (boxes, conf, alive, box_end, conf_s[:, -1], alive_end, tpl_end,
            bfill_box, bfill_conf, bfill_alive)


def _snap_sample(ti, tc_valid: int, stride: int):
    """Seed frame → nearest sample index, clamped to the last REAL sample.

    The rounding of the batch tracker's anchor snap ((ti + s//2) // s); the
    clamp keeps a rounded-up seed on a real frame of a padded chunk.
    ``ti`` is a python int (host engine) or a long tensor (fused step, never
    read back to the host); ``tc_valid`` is the chunk's count of real frames.
    """
    s = stride
    last = max((tc_valid - 1) // s, 0)
    if isinstance(ti, (int, np.integer)):
        return int(min((ti + s // 2) // s, last))
    return torch.clamp((ti + s // 2) // s, max=last)


def _backtrack_entries_strided(bb_row, ba_row, t_global: int, chunk: int, stride: int,
                               seed_ti: int, seed_box):
    """Upsample one backtracked lane from sample space to frame entries.

    Window sample j covers global frame (t_global - chunk) + stride*j. The
    anchor sample is patched alive with the SEED BOX so the interpolation
    bridges the gap up to the seed; only frames strictly BEFORE the seed are
    emitted (the caller records the seed entry). Pure numpy, the JAX
    function's arithmetic; both engines call it. As in JAX, the caller
    passes the option's ``chunk``, not the chunk's valid length.
    """
    s = stride
    Ts = chunk // s
    anchor_j = Ts + _snap_sample(seed_ti, chunk, s)
    base = t_global - chunk
    bb = np.asarray(bb_row, np.float32)
    ba = np.asarray(ba_row, bool)
    bx = bb.copy()
    ba_p = ba.copy()
    if anchor_j < 2 * Ts:
        bx[anchor_j] = np.asarray(seed_box, np.float32)
        ba_p[anchor_j] = True
    seed_abs = t_global + seed_ti
    entries = []
    for j in range(2 * Ts):
        g = base + s * j
        if ba[j] and 0 <= g < seed_abs:
            entries.append((g, bb[j].copy(), 0.0))
        if j + 1 < 2 * Ts and ba[j] and ba_p[j + 1]:
            for r in range(1, s):
                g2 = g + r
                if 0 <= g2 < seed_abs:
                    fr = np.float32(r / s)
                    box = ((1.0 - fr) * bx[j] + fr * bx[j + 1]).astype(np.float32)
                    entries.append((g2, box, 0.0))
    return entries


def backtrack_seeds(cfg, feats_window, anchor_ts, anchor_boxes, templates, seeded,
                    conf_thresh: float):
    """Track fresh seeds BACKWARD over the retained feature window.

    Args:
      feats_window: (Tw, h, w, C) — previous chunk + current chunk features.
      anchor_ts: (A,) window-local anchor positions; anchor_boxes: (A, 4);
      templates: (A, P, P, C); seeded: (A,) bool — lanes seeded this chunk.
    Returns:
      boxes (A, Tw, 4), alive (A, Tw) — alive only BEFORE each lane's anchor
      (the caller records the anchor entry), False for unseeded lanes.
    """
    boxes, _, alive = _track_one_direction(
        feats_window, anchor_ts, anchor_boxes, templates, cfg, conf_thresh, reverse=True
    )
    t_idx = torch.arange(feats_window.shape[0], device=feats_window.device)
    return boxes, alive & (t_idx[None, :] < anchor_ts[:, None]) & seeded[:, None]


def _mgp_chunk(frames_ext, rois, cls_scores, keep, prev_rois, prev_scores, prev_keep,
               decay: float, preset: str = "fast"):
    """One chunk of motion-guided propagation (t±1, one-frame forward halo).

    frames_ext (Tc+1, H, W, 3): [previous last frame] + chunk; rois (Tc, R, 4);
    cls_scores/keep (Tc, C-1, R); prev_* the previous chunk's last frame.
    Returns merged (boxes (Tc, 3R, 4), scores (Tc, C-1, 3R), valid
    (Tc, C-1, 3R)) in slot blocks [native, fwd, bwd].
    """
    R = rois.shape[1]
    coord_scale = flow_coord_scale(preset)
    flow_kw = dict(preset=preset, upsample=(coord_scale == 1.0))
    fwd = flow_video(frames_ext, **flow_kw)  # fwd[i]: ext[i] → ext[i+1]
    bwd = flow_video(frames_ext.flip(0), **flow_kw).flip(0)  # bwd[i]: ext[i+1] → ext[i]

    # forward hop INTO chunk[i]: source ext[i] = prev_last (i = 0) or chunk[i-1]
    src_boxes = torch.cat([prev_rois[None], rois[:-1]])
    src_scores = torch.cat([prev_scores[None], cls_scores[:-1]])
    src_keep = torch.cat([prev_keep[None], keep[:-1]])
    shifts = mean_flow_in_boxes(fwd, src_boxes * coord_scale, src_keep.any(1))
    fwd_boxes = shift_boxes(src_boxes, shifts)

    # backward hop INTO chunk[i]: source chunk[i+1] via bwd[i+1]; the last
    # frame has no in-chunk future source
    nsrc_boxes = torch.cat([rois[1:], rois.new_zeros((1, R, 4))])
    nsrc_scores = torch.cat([cls_scores[1:], torch.zeros_like(cls_scores[:1])])
    nsrc_keep = torch.cat([keep[1:], torch.zeros_like(keep[:1])])
    bflow = torch.cat([bwd[1:], torch.zeros_like(bwd[:1])])
    bshifts = mean_flow_in_boxes(bflow, nsrc_boxes * coord_scale, nsrc_keep.any(1))
    bwd_boxes = shift_boxes(nsrc_boxes, bshifts)

    m_boxes = torch.cat([rois, fwd_boxes, bwd_boxes], dim=1)
    m_scores = torch.cat([cls_scores, src_scores * decay, nsrc_scores * decay], dim=2)
    m_valid = torch.cat([keep, src_keep, nsrc_keep], dim=2)
    return m_boxes, m_scores, m_valid


def _detect_stage(det_model, frames, rois, halo_frame, carry: StreamCarry, opts: StreamOptions):
    """Detection, per-frame NMS and MGP of one chunk, as both engines run it.

    Returns (out_boxes (Tc, N, 4), out_scores (Tc, C-1, N), out_keep
    (Tc, C-1, N), cls_scores (Tc, C-1, R), keep (Tc, C-1, R)); N = 3R with
    MGP, else R.
    """
    Tc, C = frames.shape[0], opts.num_classes
    with record_function("stream.detect"):
        probs, boxes = _detect_step(det_model, frames, rois, True)
    cls_scores = probs[:, :, 1:].transpose(1, 2).contiguous()  # (Tc, C-1, R)
    cls_boxes = boxes[:, :, 1:, :].transpose(1, 2)  # (Tc, C-1, R, 4)
    with record_function("stream.nms"):
        keep = batched_nms(cls_boxes, cls_scores, cls_scores > 0.01, opts.nms_thresh)
    if not opts.mgp:
        return rois, cls_scores, keep, cls_scores, keep
    with record_function("stream.mgp"):
        frames_ext = torch.cat([halo_frame[None], frames])
        m_boxes, m_scores, m_valid = _mgp_chunk(
            frames_ext, rois, cls_scores, keep, carry.prev_rois, carry.prev_scores,
            carry.prev_keep, opts.mgp_decay, preset=opts.flow_preset,
        )
    with record_function("stream.mgp_nms"):
        m_keep = batched_nms(
            m_boxes[:, None].expand((Tc, C - 1) + m_boxes.shape[1:]), m_scores,
            m_valid & (m_scores > 0), opts.nms_thresh,
        )
    return m_boxes, m_scores, m_keep, cls_scores, keep


def _track_stage(trk_model, trk_cfg, frames, carry: StreamCarry, stride: int,
                 opts: StreamOptions):
    """Tracker features of the chunk's samples and the carried slots'
    advance, as both engines run it.

    Returns (feats (Tc // stride, h, w, C), tb (A, Tc, 4), tc (A, Tc), ta (A, Tc),
    box_end, conf_end, alive_end, tpl_end, bf_box, bf_conf, bf_alive); the
    boundary fill bf_* is zero at stride 1.
    """
    A = opts.track_slots
    with record_function("stream.track_features"):
        feats = tracker_features(trk_model, frames[::stride] if stride > 1 else frames)
    with record_function("stream.track_chunk"):
        if stride > 1:
            return (feats,) + track_chunk_strided(
                trk_cfg, feats, carry.templates, carry.boxes, carry.alive, carry.bnd_box,
                carry.bnd_conf, carry.bnd_alive, opts.conf_thresh, stride, frames.shape[0],
            )
        tb, tc_, ta, box_end, alive_end, tpl_end = track_chunk(
            trk_cfg, feats, carry.templates, carry.boxes, carry.alive, opts.conf_thresh
        )
    return (feats, tb, tc_, ta, box_end, tc_[:, -1], alive_end, tpl_end,
            torch.zeros_like(carry.bnd_box), torch.zeros_like(carry.bnd_conf),
            torch.zeros_like(carry.bnd_alive))


def _backtrack_window(carry: StreamCarry, feats):
    """[previous chunk's features (zeros at the start)] + this chunk's."""
    prev = carry.prev_feats if carry.prev_feats is not None else torch.zeros_like(feats)
    return torch.cat([prev, feats])


def make_stream_chunk_fn(det_model, trk_model, trk_cfg, opts: StreamOptions):
    """Build the one-step-per-chunk program of the fused engine.

    Returns ``(step, unpack)``: ``step(frames, rois, tc_valid, halo_frame,
    carry) -> (carry', halo', packed)`` runs one chunk on the models' device
    (frames (Tc, H, W, 3) uint8 and rois (Tc, R, 4) there, ``tc_valid`` the
    count of real frames); ``unpack(packed.cpu().numpy())`` gives the
    host-output dict. The carry stays on the device, and all host outputs
    travel in ONE flat float32 tensor, so a chunk costs one transfer.

    The greedy seeding replicates the host engine's walk: ``A`` self-gated
    steps, each taking the best available candidate (argmax ties = lowest
    flat index = (frame asc, slot asc)), with the same strict-> IoU coverage
    and clash tests, claiming free slots in ascending index order. The JAX
    program pins its tracker subcomputations with optimization barriers so
    that its two engines compile bit-identically; eager PyTorch fuses
    nothing, so there is nothing to pin here.
    """
    s = _stride(opts)
    A, R, C = opts.track_slots, opts.max_rois, opts.num_classes
    Tc = opts.chunk
    Ts = Tc // s  # samples a chunk
    Tw = Ts  # the retained previous chunk's length, in samples
    N = 3 * R if opts.mgp else R
    out_spec = [
        ("out_boxes", (Tc, N, 4)),
        ("out_scores", (Tc, C - 1, N)),
        ("out_keep", (Tc, C - 1, N)),
        ("tb", (A, Tc, 4)),
        ("tc", (A, Tc)),
        ("ta", (A, Tc)),
        ("seed_slot", (A,)),
        ("seed_ti", (A,)),
        ("seed_box", (A, 4)),
        ("seed_score", (A,)),
        ("seed_ok", (A,)),
        ("bb", (A, 2 * Ts, 4)),
        ("balive", (A, 2 * Ts)),
        # the boundary fill of the previous chunk's last frame (zeros at stride 1)
        ("bf_box", (A, 4)),
        ("bf_conf", (A,)),
        ("bf_alive", (A,)),
    ]

    def unpack(flat: np.ndarray) -> dict:
        out, off = {}, 0
        for name, shape in out_spec:
            size = int(np.prod(shape))
            out[name] = flat[off : off + size].reshape(shape)
            off += size
        return out

    @torch.no_grad()
    def step(frames, rois, tc_valid: int, halo_frame, carry: StreamCarry):
        dev = frames.device
        out_boxes, out_scores, out_keep, cls_scores, keep = _detect_stage(
            det_model, frames, rois, halo_frame, carry, opts)
        (feats, tb, tc_, ta, box_end, conf_end, alive_end, tpl_end,
         bf_box, bf_conf, bf_alive) = _track_stage(trk_model, trk_cfg, frames, carry, s, opts)

        # --- greedy seeding: A self-gated steps, no host synchronisation ---
        with record_function("stream.seed"):
            best_scores = torch.where(
                out_keep.transpose(1, 2), out_scores.transpose(1, 2), 0.0
            ).amax(2)  # (Tc, N)
            iou_atn = pairwise_iou(tb[:, :, None, :], out_boxes[None])[:, :, 0]  # (A, Tc, N)
            cov0 = ((iou_atn > opts.cover_thresh) & ta[:, :, None]).any(0)  # (Tc, N)
            F = Tc * N
            b_flat = out_boxes.reshape(F, 4)
            s_flat = best_scores.reshape(F)
            t_flat = torch.arange(F, device=dev) // N
            slot_ar = torch.arange(F, device=dev)
            avail = ~cov0.reshape(F) & (t_flat < tc_valid)
            free = ~alive_end  # the free list BEFORE seeding
            n_free = free.sum()
            free_rank = torch.cumsum(free.long(), 0) - 1
            arange_a = torch.arange(A, device=dev)
            count = torch.zeros((), dtype=torch.long, device=dev)
            sboxes, salive = box_end, alive_end
            neg_inf = s_flat.new_full((), float("-inf"))
            recs = []
            for _ in range(A):
                sc = torch.where(avail, s_flat, neg_inf)
                i = torch.argmax(sc)  # ties: first maximum = (frame asc, slot asc)
                si = _take(sc, i)
                ok = (si >= opts.seed_thresh) & (count < n_free)
                cand = _take(b_flat, i)
                ti = _take(t_flat, i)
                slot = torch.where(free & (free_rank == count), arange_a, 0).sum()
                claim = ok & (arange_a == slot)  # (A,): the claimed slot, if any
                sboxes = torch.where(claim[:, None], cand, sboxes)
                salive = salive | claim
                clash = (t_flat == ti) & (pairwise_iou(cand[None], b_flat)[0] > opts.cover_thresh)
                avail = torch.where(ok, avail & ~clash & (slot_ar != i), avail)
                count = count + ok.long()
                recs.append((torch.where(ok, slot, -1), ti, cand, si, ok))
            seed_slot, seed_ti, seed_box, seed_score, seed_ok = (
                torch.stack(r) for r in zip(*recs)
            )
            # at stride 2 the features hold samples only: the template and the
            # backtrack anchor take the seed's nearest real sample, while the
            # seed keeps its own frame and box
            seed_ti_ex = _snap_sample(seed_ti, tc_valid, s) if s > 1 else seed_ti
            # templates of the fresh seeds; unseeded steps land in a dummy row
            scat = torch.where(seed_ok, seed_slot, A)
            new_tmpl = _extract_templates_core(feats, seed_ti_ex, seed_box, trk_cfg)
            templates_x = torch.cat([tpl_end, torch.zeros_like(tpl_end[:1])])
            templates_x = templates_x.index_put(
                (scat,), torch.where(seed_ok[:, None, None, None], new_tmpl, 0.0)
            )
            new_templates = templates_x[:A]

        # --- backward re-tracking of fresh seeds over the window ---
        if opts.backtrack:
            with record_function("stream.backtrack"):
                window = _backtrack_window(carry, feats)
                anchor_ts = torch.zeros((A + 1,), dtype=torch.long, device=dev)
                anchor_ts = anchor_ts.index_put((scat,), Tw + seed_ti_ex)[:A]
                anchor_boxes = seed_box.new_zeros((A + 1, 4)).index_put((scat,), seed_box)[:A]
                lane_on = seed_ok.new_zeros((A + 1,)).index_put((scat,), seed_ok)[:A]
                bb, balive = backtrack_seeds(
                    trk_cfg, window, anchor_ts, anchor_boxes, new_templates, lane_on,
                    opts.conf_thresh,
                )
        else:
            bb = torch.zeros((A, 2 * Ts, 4), dtype=torch.float32, device=dev)
            balive = torch.zeros((A, 2 * Ts), dtype=torch.bool, device=dev)

        last = tc_valid - 1
        carry_out = StreamCarry(new_templates, sboxes, salive, rois[last], cls_scores[last],
                                keep[last], feats, box_end, conf_end, alive_end)
        outs = dict(out_boxes=out_boxes, out_scores=out_scores, out_keep=out_keep, tb=tb,
                    tc=tc_, ta=ta, seed_slot=seed_slot, seed_ti=seed_ti, seed_box=seed_box,
                    seed_score=seed_score, seed_ok=seed_ok, bb=bb, balive=balive,
                    bf_box=bf_box, bf_conf=bf_conf, bf_alive=bf_alive)
        packed = torch.cat([outs[name].float().reshape(-1) for name, _ in out_spec])
        return carry_out, frames[last], packed

    return step, unpack


class _TrackBook:
    """The host bookkeeping both engines share: global track ids per slot,
    the per-track segments (frame, box, score), the boundary fill and the
    end-of-stream hold at track_stride 2 — the JAX engines' bookkeeping."""

    def __init__(self, opts: StreamOptions, stride: int):
        self.opts, self.s = opts, stride
        self.slot_id = -np.ones(opts.track_slots, np.int64)
        self.next_id = 0
        self.tracks: dict[int, list] = {}
        self.pending = False  # a full chunk's last frame awaits its boundary fill

    def add_chunk(self, out: dict, seeds, Tc: int, t_global: int) -> None:
        """One chunk's host outputs: numpy ``tb``/``tc``/``ta`` (A, chunk),
        ``bf_box``/``bf_conf``/``bf_alive``, and ``bb``/``balive`` (A,
        2 × samples) of the backtrack; ``seeds`` lists (slot, ti, box, score)
        in seeding order. Alive fields are read as ``> 0.5``."""
        opts, s = self.opts, self.s
        if self.pending:  # the previous chunk's last frame, now that its right sample exists
            for a in np.nonzero(out["bf_alive"] > 0.5)[0]:
                if self.slot_id[a] >= 0:
                    self.tracks.setdefault(int(self.slot_id[a]), []).append(
                        (t_global - 1, out["bf_box"][a].copy(), float(out["bf_conf"][a])))
        pend_local = opts.chunk - 1 if (s > 1 and Tc == opts.chunk) else None
        self.pending = pend_local is not None
        tb, ta, tcs = out["tb"], out["ta"] > 0.5, out["tc"]
        for a in range(opts.track_slots):
            if self.slot_id[a] < 0:
                continue
            seg = self.tracks.setdefault(int(self.slot_id[a]), [])
            for i in range(Tc):
                if i != pend_local and ta[a, i]:
                    seg.append((t_global + i, tb[a, i], float(tcs[a, i])))

        lanes = {}  # slot → (track id, seed frame, seed box)
        for a, ti, box, score in seeds:
            self.slot_id[a] = self.next_id
            self.tracks[self.next_id] = [(t_global + ti, box.copy(), float(score))]
            lanes[a] = (self.next_id, ti, box)
            self.next_id += 1
        if not opts.backtrack:
            return
        Tw = opts.chunk // s  # window position j < Tw: the previous chunk
        for a, (tid, ti, box) in lanes.items():
            seg = self.tracks[tid]
            balive = out["balive"][a] > 0.5
            if s > 1:
                seg.extend(_backtrack_entries_strided(out["bb"][a], balive, t_global,
                                                      opts.chunk, s, ti, box))
            else:
                for j in np.nonzero(balive)[0]:
                    if t_global - Tw + j >= 0:
                        seg.append((int(t_global - Tw + j), out["bb"][a, j], 0.0))
            seg.sort(key=lambda e: e[0])

    def finish(self, carry: StreamCarry, t_global: int) -> dict:
        """The end of the stream: a pending last frame has no right sample
        and holds the scan-end sample (the carry is read once)."""
        if self.pending:
            bnd_box, bnd_conf, bnd_alive = (x.cpu().numpy() for x in
                                            (carry.bnd_box, carry.bnd_conf, carry.bnd_alive))
            for a in np.nonzero(bnd_alive)[0]:
                if self.slot_id[a] >= 0:
                    self.tracks.setdefault(int(self.slot_id[a]), []).append(
                        (t_global - 1, bnd_box[a].copy(), float(bnd_conf[a])))
        return self.tracks


def _chunk_inputs(chunk, rois_per_frame, t_global: int, opts: StreamOptions):
    """A chunk padded to ``opts.chunk`` frames with its proposals →
    (frames (chunk, H, W, 3) uint8, rois (chunk, R, 4) float32, real frames)."""
    Tc = chunk.shape[0]
    pad = opts.chunk - Tc
    if pad:
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)], axis=0)
    if callable(rois_per_frame):
        rois = np.stack([rois_per_frame(t_global + i) for i in range(opts.chunk)])
        rois = rois.astype(np.float32)
    else:
        rois = np.zeros((opts.chunk, opts.max_rois, 4), np.float32)
        avail = rois_per_frame[t_global : t_global + Tc]
        rois[: len(avail)] = avail
    return np.ascontiguousarray(chunk), rois, Tc


def stream_video(det_model, trk_model, trk_cfg, frame_chunks: Iterator[np.ndarray],
                 rois_per_frame, opts: StreamOptions = StreamOptions()):
    """Process a stream of frame chunks; returns collected arrays + tracks.

    The JAX function's arguments without the parameter trees (the port's
    models carry their weights); everything runs on the models' device.

    Args:
      frame_chunks: yields (Tc, H, W, 3) uint8 arrays, Tc == opts.chunk (the
        last chunk may be shorter; it is padded here).
      rois_per_frame: callable (global_t) -> (R, 4) proposals, or a
        (T_total, R, 4) array.
    Returns:
      dict with per-frame detection arrays (boxes/scores/keep — the slot
      axis is 3R when opts.mgp else R), seq-NMS scores + path ids, the
      per-track segments, and ``metrics``: the run's ``StageMetrics("stream")``
      record. Its counters: ``frames``, ``tracks``, ``chunks``, ``seeds``
      (taken), ``seed_steps`` (``track_slots`` a chunk), ``backtrack_live``
      (lane-steps alive in the backtrack), ``backtrack_run`` (lane-steps
      run: ``track_slots`` × 2 × samples a backtracked chunk; the fused
      engine backtracks every chunk, the host engine those that seed), and
      seq-NMS's ``paths``, ``path_iters_live`` and ``path_iters_run``
      (``video/link.py::path_counts``).
    """
    if opts.engine not in ENGINES:
        raise ValueError(f"stream engine {opts.engine!r}: one of {ENGINES}")
    run = _stream_video_fused if opts.engine == "fused" else _stream_video_host
    return run(det_model, trk_model, trk_cfg, frame_chunks, rois_per_frame, opts)


def _stream_video_fused(det_model, trk_model, trk_cfg, frame_chunks, rois_per_frame,
                        opts: StreamOptions):
    """Host loop around :func:`make_stream_chunk_fn`: iterates chunks,
    threads the device-resident carry and MGP halo frame, unpacks the one
    packed output per chunk, and keeps the host bookkeeping."""
    metrics = StageMetrics("stream")
    A = opts.track_slots
    dev = next(det_model.parameters()).device
    step, unpack = make_stream_chunk_fn(det_model, trk_model, trk_cfg, opts)
    book = _TrackBook(opts, _stride(opts))
    all_boxes, all_scores, all_keep = [], [], []
    t_global = 0
    carry = halo = None

    for chunk in frame_chunks:
        chunk, rois, Tc = _chunk_inputs(chunk, rois_per_frame, t_global, opts)
        frames_t = torch.from_numpy(chunk).to(dev)
        if carry is None:
            carry = init_carry(opts, trk_cfg, dev)
            halo = frames_t[0]  # the first chunk's halo is its own first frame
        carry, halo, packed = step(frames_t, torch.from_numpy(rois).to(dev), Tc, halo, carry)
        out = unpack(packed.cpu().numpy())
        seeds = [(int(out["seed_slot"][k]), int(out["seed_ti"][k]), out["seed_box"][k],
                  out["seed_score"][k]) for k in range(A) if out["seed_ok"][k] > 0.5]
        _count_chunk(metrics, out, seeds, opts)
        book.add_chunk(out, seeds, Tc, t_global)
        all_boxes.append(out["out_boxes"][:Tc])
        all_scores.append(out["out_scores"][:Tc])
        all_keep.append(out["out_keep"][:Tc] > 0.5)
        t_global += Tc

    return _finalize_stream(all_boxes, all_scores, all_keep, book.finish(carry, t_global),
                            t_global, opts, metrics, dev)


def _count_chunk(metrics: StageMetrics, out: dict, seeds, opts: StreamOptions) -> None:
    """A chunk's seeding and backtrack counters (see :func:`stream_video`),
    from its host outputs: ``out`` holds ``balive`` where the chunk's step
    packed one (the fused engine always; the host engine where it
    backtracked)."""
    metrics.add("chunks")
    metrics.add("seeds", len(seeds))
    metrics.add("seed_steps", opts.track_slots)
    if opts.backtrack and "balive" in out:
        metrics.add("backtrack_live", int((out["balive"] > 0.5).sum()))
        metrics.add("backtrack_run", out["balive"].size)


def _seed_host(out_boxes, out_scores, out_keep, tb, ta, alive_end, Tc: int,
               opts: StreamOptions):
    """The JAX host engine's greedy seeding, in numpy: candidates in stable
    descending order of their best kept class score, skipped where a live
    track or an earlier seed of the same frame covers them (IoU strictly
    above ``cover_thresh``), each claiming the lowest free slot (free: not
    alive at the scan's end). Returns [(slot, ti, box, score)]."""
    A, N = opts.track_slots, out_boxes.shape[1]
    best = np.where(np.moveaxis(out_keep, 1, 2), np.moveaxis(out_scores, 1, 2), 0.0).max(axis=2)
    free = [a for a in range(A) if not alive_end[a]]
    seeds = []
    for fi in np.argsort(-best.ravel(), kind="stable"):
        if not free:
            break
        ti, ri = divmod(int(fi), N)
        if best[ti, ri] < opts.seed_thresh:
            break  # sorted descending: everything after is below the threshold
        if ti >= Tc:
            continue  # a padded frame: zero boxes with arbitrary scores
        cand = out_boxes[ti, ri]
        live = [tb[a, ti] for a in range(A) if ta[a, ti]]
        live += [box for _, tj, box, _ in seeds if tj == ti]
        if live and np_iou(cand[None], np.stack(live)).max() > opts.cover_thresh:
            continue
        seeds.append((free.pop(0), ti, cand.copy(), best[ti, ri]))
    return seeds


@torch.no_grad()
def _stream_video_host(det_model, trk_model, trk_cfg, frame_chunks, rois_per_frame,
                       opts: StreamOptions):
    """The host engine: the stages one call at a time on the models' device,
    the outputs read back after each chunk's slot advance, the greedy seeding
    on the host (:func:`_seed_host`), then the templates and the backtrack of
    the fresh seeds on the device — the JAX host engine's order."""
    metrics = StageMetrics("stream")
    A = opts.track_slots
    s = _stride(opts)
    Tw = opts.chunk // s
    dev = next(det_model.parameters()).device
    book = _TrackBook(opts, s)
    all_boxes, all_scores, all_keep = [], [], []
    t_global = 0
    carry = init_carry(opts, trk_cfg, dev)
    halo = None

    for chunk in frame_chunks:
        chunk, rois_np, Tc = _chunk_inputs(chunk, rois_per_frame, t_global, opts)
        frames = torch.from_numpy(chunk).to(dev)
        rois = torch.from_numpy(rois_np).to(dev)
        if halo is None:
            halo = frames[0]
        out_boxes, out_scores, out_keep, cls_scores, keep = _detect_stage(
            det_model, frames, rois, halo, carry, opts)
        (feats, tb, tc_, ta, box_end, conf_end, alive_end, tpl_end,
         bf_box, bf_conf, bf_alive) = _track_stage(trk_model, trk_cfg, frames, carry, s, opts)
        out = {k: v.cpu().numpy() for k, v in dict(
            out_boxes=out_boxes, out_scores=out_scores, out_keep=out_keep, tb=tb, tc=tc_,
            ta=ta, bf_box=bf_box, bf_conf=bf_conf, bf_alive=bf_alive).items()}

        with record_function("stream.seed"):
            alive_np = alive_end.cpu().numpy().copy()  # the slots after seeding
            seeds = _seed_host(out["out_boxes"], out["out_scores"], out["out_keep"], out["tb"],
                               out["ta"], alive_np, Tc, opts)
            boxes_np = box_end.cpu().numpy().copy()
            new_templates = tpl_end
            if seeds:
                slots = torch.tensor([a for a, _, _, _ in seeds], device=dev)
                ti_arr = np.zeros(A, np.int64)
                bx_arr = np.zeros((A, 4), np.float32)
                for k, (a, ti, box, _) in enumerate(seeds):
                    ti_arr[k] = _snap_sample(ti, Tc, s) if s > 1 else ti
                    bx_arr[k] = box
                    boxes_np[a], alive_np[a] = box, True
                tmpl = _extract_templates_core(feats, torch.from_numpy(ti_arr).to(dev),
                                               torch.from_numpy(bx_arr).to(dev), trk_cfg)
                new_templates = tpl_end.index_put((slots,), tmpl[: len(seeds)])

        if opts.backtrack and seeds:
            with record_function("stream.backtrack"):
                anchor_ts = np.zeros(A, np.int64)
                anchor_boxes = np.zeros((A, 4), np.float32)
                lane_on = np.zeros(A, bool)
                for a, ti, box, _ in seeds:
                    anchor_ts[a] = Tw + (_snap_sample(ti, Tc, s) if s > 1 else ti)
                    anchor_boxes[a], lane_on[a] = box, True
                bb, balive = backtrack_seeds(
                    trk_cfg, _backtrack_window(carry, feats), torch.from_numpy(anchor_ts).to(dev),
                    torch.from_numpy(anchor_boxes).to(dev), new_templates,
                    torch.from_numpy(lane_on).to(dev), opts.conf_thresh,
                )
                out["bb"], out["balive"] = bb.cpu().numpy(), balive.cpu().numpy()
        _count_chunk(metrics, out, seeds, opts)
        book.add_chunk(out, seeds, Tc, t_global)

        last = Tc - 1
        carry = StreamCarry(new_templates, torch.from_numpy(boxes_np).to(dev),
                            torch.from_numpy(alive_np).to(dev), rois[last], cls_scores[last],
                            keep[last], feats, box_end, conf_end, alive_end)
        halo = frames[last]
        all_boxes.append(out["out_boxes"][:Tc])
        all_scores.append(out["out_scores"][:Tc])
        all_keep.append(out["out_keep"][:Tc])
        t_global += Tc

    return _finalize_stream(all_boxes, all_scores, all_keep, book.finish(carry, t_global),
                            t_global, opts, metrics, dev)


def _finalize_stream(all_boxes, all_scores, all_keep, track_segments, t_global, opts,
                     metrics, device):
    """Global seq-NMS over the collected arrays (on ``device``) + result dict."""
    boxes_full = np.concatenate(all_boxes, axis=0)  # (T, N, 4)
    scores_full = np.concatenate(all_scores, axis=0)  # (T, C-1, N)
    keep_full = np.concatenate(all_keep, axis=0)
    with torch.no_grad(), record_function("stream.seq_nms"):
        seq_scores, path_ids = seq_nms_batch(
            torch.from_numpy(boxes_full).to(device),
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(scores_full, 1, 0))).to(device),
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(keep_full, 1, 0))).to(device),
            opts.link_thresh, opts.suppress_thresh, max_paths=opts.max_paths,
        )
    path_ids = path_ids.cpu().numpy()
    metrics.set("frames", t_global)
    metrics.set("tracks", len(track_segments))
    for name, value in path_counts(path_ids, opts.max_paths).items():
        metrics.set(name, value)
    return {
        "boxes": boxes_full,
        "scores": scores_full,
        "keep": keep_full,
        "seq_scores": seq_scores.cpu().numpy(),
        "path_ids": path_ids,
        "tracks": track_segments,
        "num_frames": t_global,
        "metrics": metrics.finish(),
    }


def stream_to_protos(result: dict, frame_ids, video: str, class_names=None,
                     min_score: float = 0.0) -> tuple[dict, dict, dict]:
    """Collected stream arrays → (final det_proto, tubelet track_proto,
    online-tracker track_proto), as the JAX function emits them."""
    from vdetlib_tpu_torch.protos.arrays import arrays_to_det_proto
    from vdetlib_tpu_torch.video.link import tubelets_from_path_ids

    boxes = np.asarray(result["boxes"])  # (T, N, 4)
    seq_scores = np.asarray(result["seq_scores"])  # (C-1, T, N)
    path_ids = np.asarray(result["path_ids"])
    T, N = boxes.shape[:2]
    assert len(frame_ids) == T, (len(frame_ids), T)
    C = seq_scores.shape[0] + 1
    new_scores = np.zeros((T, N, C), np.float32)
    new_scores[:, :, 1:] = np.moveaxis(np.maximum(seq_scores, 0.0), 0, 2)
    mask = np.asarray(result["keep"]).any(axis=1)  # (T, N)
    det_proto = arrays_to_det_proto(boxes, new_scores, mask, frame_ids, video,
                                    class_names=class_names, score_thresh=min_score)
    tubelets = tubelets_from_path_ids(boxes, seq_scores, path_ids, frame_ids, video,
                                      first_class=1)
    tracks = []
    for tid in sorted(result["tracks"]):
        entries = [
            {"frame": int(frame_ids[t]), "bbox": [float(v) for v in np.asarray(b)],
             "score": float(s)}
            for t, b, s in result["tracks"][tid]
            if 0 <= t < T
        ]
        if entries:
            tracks.append(entries)
    track_proto = {"video": video, "method": "stream_tracker", "tracks": tracks}
    return det_proto, tubelets, track_proto
