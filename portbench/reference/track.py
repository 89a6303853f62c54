"""Correlation tracking in plain PyTorch: the folded forward+backward scan
of the batch tracker and the one-direction scan of the stream's backtrack
(frozen copies of the port's ``track_scan_plain``, ``track_batch`` and
``_track_one_direction`` at one scale, frozen templates and no snapping,
the options the benchmark's configurations state).
"""

from __future__ import annotations

import torch

from portbench.reference.nets import extract_template, ncc_update


def track_scan(feats, anchor_ts, anchor_boxes, templates, arch, prec, conf_thresh: float):
    """The folded scan: T steps over 2A lanes; step i advances the forward
    lanes at frame i and the backward lanes at frame T-1-i.
    Returns (fb, fc, fa, bb, bc, ba), each indexed by frame (T, A, ...)."""
    T = feats.shape[0]
    dev = feats.device
    A = anchor_ts.shape[0]
    tpl2 = templates[None].expand((2,) + templates.shape)
    ar = torch.arange(T, device=dev)
    ts_all = torch.stack([ar, ar.flip(0)], dim=1)
    box_st = torch.zeros((2, A, 4), dtype=torch.float32, device=dev)
    alive_st = torch.zeros((2, A), dtype=torch.bool, device=dev)
    out_b, out_c, out_a = [], [], []
    for i in range(T):
        ts2 = ts_all[i]
        started = ts2[:, None] == anchor_ts[None, :]
        box = torch.where(started[..., None], anchor_boxes[None], box_st)
        alive2 = alive_st | started
        feat2 = torch.stack([feats[i], feats[T - 1 - i]])
        new_box, peak = ncc_update(feat2, box, tpl2, arch, prec)
        track_now = alive2 & (ts2[:, None] != anchor_ts[None, :])
        ok = peak > conf_thresh
        new_alive = torch.where(track_now, alive2 & ok, alive2)
        new_box = torch.where((track_now & ok)[..., None], new_box, box)
        out_b.append(new_box)
        out_c.append(torch.where(started, torch.ones_like(peak), peak))
        out_a.append(started | new_alive)
        box_st, alive_st = new_box, new_alive
    ob, oc, oa = torch.stack(out_b, 1), torch.stack(out_c, 1), torch.stack(out_a, 1)
    return ob[0], oc[0], oa[0], ob[1].flip(0), oc[1].flip(0), oa[1].flip(0)


def track_one_direction(feats, anchor_t, anchor_box, template, arch, prec,
                        conf_thresh: float, reverse: bool):
    """Scan the whole frame axis for L anchors in one direction → boxes
    (L, T, 4), conf (L, T), alive (L, T); entries before each anchor (in scan
    direction) are dead, the anchor frame is alive with conf 1."""
    T = feats.shape[0]
    L = anchor_t.shape[0]
    dev = feats.device
    box = torch.zeros((L, 4), dtype=torch.float32, device=dev)
    alive = torch.zeros((L,), dtype=torch.bool, device=dev)
    tpl = template[None]
    out_b, out_c, out_a = [], [], []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        started = anchor_t == t
        box = torch.where(started[:, None], anchor_box, box)
        alive = alive | started
        new_box, peak = ncc_update(feats[t][None], box[None], tpl, arch, prec)
        new_box, peak = new_box[0], peak[0]
        track_now = alive & ~started
        ok = peak > conf_thresh
        new_alive = torch.where(track_now, alive & ok, alive)
        new_box = torch.where((track_now & ok)[:, None], new_box, box)
        out_b.append(new_box)
        out_c.append(torch.where(started, torch.ones_like(peak), peak))
        out_a.append(started | new_alive)
        box, alive = new_box, new_alive
    if reverse:
        out_b, out_c, out_a = out_b[::-1], out_c[::-1], out_a[::-1]
    return torch.stack(out_b, 1), torch.stack(out_c, 1), torch.stack(out_a, 1)


def track_batch(arch, prec, feats_s, anchor_ts, anchor_boxes, conf_thresh: float, stride: int,
                full_t: int, valid_t):
    """Track A anchors forward and backward over every ``stride``-th frame's
    features ``feats_s`` (ceil(full_t / stride) rows), interpolating the
    skipped frames (alive where both samples are) and re-asserting each
    anchor at its own frame → boxes (A, T, 4), conf (A, T), alive (A, T).
    ``valid_t``: the count of real frames of a bucket-padded video."""
    s = int(stride)
    T = int(full_t)
    dev = anchor_ts.device
    Ts = feats_s.shape[0]
    if s > 1:
        last_sample = torch.clamp(torch.as_tensor(valid_t, device=dev) - 1, min=0) // s
        zero = torch.zeros((), dtype=anchor_ts.dtype, device=dev)
        ats = torch.clamp((anchor_ts + s // 2) // s, zero, last_sample.to(anchor_ts.dtype))
    else:
        last_sample = torch.tensor(Ts - 1, device=dev)
        ats = anchor_ts
    templates = extract_template(feats_s[ats], anchor_boxes, arch, prec)
    outs = track_scan(feats_s, ats, anchor_boxes, templates, arch, prec, conf_thresh)
    fb, fc, fa, bb, bc, ba = (v.transpose(0, 1) for v in outs)
    use_f = torch.arange(Ts, device=dev)[None, :] >= ats[:, None]
    boxes_s = torch.where(use_f[..., None], fb, bb)
    conf_s = torch.where(use_f, fc, bc)
    alive_s = torch.where(use_f, fa, ba)
    if s == 1:
        return boxes_s, conf_s, alive_s
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
    lane = torch.arange(anchor_ts.shape[0], device=dev)
    boxes = boxes.index_put((lane, anchor_ts), anchor_boxes)
    conf = conf.index_put((lane, anchor_ts), torch.ones_like(anchor_boxes[:, 0]))
    alive = alive.index_put((lane, anchor_ts), torch.ones_like(alive[:, 0]))
    return boxes, conf, alive
