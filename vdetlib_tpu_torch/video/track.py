"""Batched correlation tracking — counterpart of ``vdetlib_tpu/video/track.py``.

Dense tracker features are computed once for all frames and shared by every
anchor. :func:`track_batch` tracks A anchors forward and backward in ONE
loop of T steps: step i advances the forward lanes at frame i and the
backward lanes at frame T-1-i, so every NCC op runs once on 2A lanes (the
JAX package's folded scan). The loop is a fixed-trip Python loop of tensor
ops with self-gated updates: no host synchronisation per step.
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.nn.heads import roi_align
from vdetlib_tpu_torch.nn.tracker_net import (
    TrackerConfig,
    correlate,
    extract_template,
    search_window,
    soft_argmax_2d,
)

__all__ = ["ncc_update", "track_batch", "tracker_features"]


def tracker_features(model, frames_u8):
    """(B, H, W, 3) uint8 → (B, h, w, C) dense tracker features."""
    x = frames_u8.float() / 255.0 - 0.5
    return model(x)


def ncc_update(feat_t, box, template, cfg: TrackerConfig):
    """One NCC tracking update per lane (no alive logic).

    Args:
      feat_t: (G, h, w, C) features of the target frame of each lane group.
      box: (G, L, 4) current boxes; template: (G, L, P, P, C) normalized.
    Returns:
      (new box candidates (G, L, 4), peak confidences (G, L)).
    """
    Q = cfg.search_pool
    P = cfg.template_pool
    R = Q - P + 1
    S = max(int(cfg.num_scales), 1)
    scales = [cfg.scale_step ** (s - (S - 1) / 2.0) for s in range(S)]
    G, L = box.shape[:2]
    cx = 0.5 * (box[..., 0] + box[..., 2])
    cy = 0.5 * (box[..., 1] + box[..., 3])
    sboxes = []
    for sc in scales:  # box resized by sc around its center
        w = (box[..., 2] - box[..., 0]) * sc
        h = (box[..., 3] - box[..., 1]) * sc
        sboxes.append(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1))
    sbox = torch.stack(sboxes, dim=2)  # (G, L, S, 4)
    win = search_window(sbox, cfg.search_factor)
    # bf16 pooling, as the JAX scan does (NCC peaks are smooth enough)
    sfeat = roi_align(
        feat_t, win.reshape(G, L * S, 4), stride=cfg.stride, pool=Q,
        compute_dtype=torch.bfloat16,
    ).reshape(G, L, S, Q, Q, -1)
    tpl = template[:, :, None].expand((G, L, S) + template.shape[-3:])
    resp = correlate(tpl, sfeat)  # (G, L, S, R, R)
    py, px, peak = soft_argmax_2d(resp)
    wx = (win[..., 2] - win[..., 0]) / Q
    wy = (win[..., 3] - win[..., 1]) / Q
    dx = (px - (R - 1) / 2.0) * wx
    dy = (py - (R - 1) / 2.0) * wy
    cand = sbox + torch.stack([dx, dy, dx, dy], dim=-1)  # (G, L, S, 4)
    if S == 1:
        return cand[:, :, 0], peak[:, :, 0]
    penalty = torch.tensor(
        [1.0 if abs(sc - 1.0) < 1e-6 else cfg.scale_penalty for sc in scales],
        dtype=torch.float32, device=box.device,
    )
    best = torch.argmax(peak * penalty, dim=-1, keepdim=True)  # first maximum
    peak = torch.gather(peak, 2, best)[..., 0]
    raw = torch.gather(cand, 2, best[..., None].expand(G, L, 1, 4))[:, :, 0]
    # damp the scale change: winner's position, blended size
    d = cfg.scale_damping
    rcx = 0.5 * (raw[..., 0] + raw[..., 2])
    rcy = 0.5 * (raw[..., 1] + raw[..., 3])
    rw = (raw[..., 2] - raw[..., 0]) * d + (box[..., 2] - box[..., 0]) * (1 - d)
    rh = (raw[..., 3] - raw[..., 1]) * d + (box[..., 3] - box[..., 1]) * (1 - d)
    new_box = torch.stack([rcx - rw / 2, rcy - rh / 2, rcx + rw / 2, rcy + rh / 2], -1)
    return new_box, peak


def track_batch(cfg: TrackerConfig, feats, anchor_ts, anchor_boxes, conf_thresh: float,
                snap=None, frame_stride: int = 1, feats_strided: bool = False,
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
    """
    if snap is not None:
        raise NotImplementedError("detection snapping is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.template_eta > 0.0:
        raise NotImplementedError("EMA templates are not ported yet (ROADMAP.md, Queue 1)")
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
        boxes_s, conf_s, alive_s = track_batch(
            cfg, feats_s, anchor_ts_s, anchor_boxes, conf_thresh, frame_stride=1,
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
    A = anchor_ts.shape[0]
    dev = feats.device
    templates = extract_template(feats[anchor_ts], anchor_boxes, cfg)  # (A, P, P, C)
    tpl2 = templates[None].expand((2,) + templates.shape)
    ar = torch.arange(T, device=dev)
    ts_all = torch.stack([ar, ar.flip(0)], dim=1)  # step i → frames (i, T-1-i)
    box_st = torch.zeros((2, A, 4), dtype=torch.float32, device=dev)
    alive_st = torch.zeros((2, A), dtype=torch.bool, device=dev)
    out_b, out_c, out_a = [], [], []
    for i in range(T):
        ts2 = ts_all[i]
        started = ts2[:, None] == anchor_ts[None, :]  # (2, A)
        box = torch.where(started[..., None], anchor_boxes[None], box_st)
        alive2 = alive_st | started
        feat2 = torch.stack([feats[i], feats[T - 1 - i]])
        new_box, peak = ncc_update(feat2, box, tpl2, cfg)
        track_now = alive2 & (ts2[:, None] != anchor_ts[None, :])
        ok = peak > conf_thresh
        new_alive = torch.where(track_now, alive2 & ok, alive2)
        new_box = torch.where((track_now & ok)[..., None], new_box, box)
        out_b.append(new_box)
        out_c.append(torch.where(started, torch.ones_like(peak), peak))
        out_a.append(started | new_alive)
        box_st, alive_st = new_box, new_alive
    # step axis: forward outputs are at frame i, backward outputs at T-1-i
    ob, oc, oa = torch.stack(out_b, 1), torch.stack(out_c, 1), torch.stack(out_a, 1)  # (2, T, A, ...)
    fb, fc, fa = ob[0].transpose(0, 1), oc[0].transpose(0, 1), oa[0].transpose(0, 1)
    bb = ob[1].flip(0).transpose(0, 1)
    bc = oc[1].flip(0).transpose(0, 1)
    ba = oa[1].flip(0).transpose(0, 1)
    use_f = ar[None, :] >= anchor_ts[:, None]  # (A, T)
    boxes = torch.where(use_f[..., None], fb, bb)
    conf = torch.where(use_f, fc, bc)
    alive = torch.where(use_f, fa, ba)
    return boxes, conf, alive
