"""The comparisons that decide ``correct``: each returns named numbers, and
each number is held to its limit in the configuration file's ``check``.

- :func:`final_dets`: a video's ``final.json`` against the reference's
  final detections. Per frame and class, detections pair up by their boxes
  (coordinates within ``box_px``); a pair agrees when its scores are within
  ``score``. The number is the share of detections, on both sides, without
  an agreeing partner.
- :func:`emissions`: the stream's per-frame arrays slot by slot (its slot
  layout is fixed): the share of slots kept on either side whose keep bit,
  box or score disagree, and the same over the video-end seq-NMS scores.
- :func:`track_steps`: the worst box gap (px) and peak gap of the
  program's tracker steps against the reference's recomputation of each
  step from the program's previous state, a track's end counting as a step
  whose peak must fall to the termination threshold. The steps come from
  the stream's tracks (:func:`stream_track_steps`) or from the fused
  engine's track arrays (:func:`fused_track_steps`).
"""

from __future__ import annotations

import json

import numpy as np


def _share(bad: int, total: int) -> float:
    return bad / total if total else 0.0


def _pair_count(p_boxes, p_scores, q_boxes, q_scores, box_px, score_tol) -> int:
    """Agreeing pairs between two detection lists of one frame and class,
    paired greedily by the smallest coordinate gap within ``box_px``."""
    if not len(p_boxes) or not len(q_boxes):
        return 0
    gap = np.abs(np.asarray(p_boxes)[:, None, :] - np.asarray(q_boxes)[None, :, :]).max(-1)
    agree = 0
    used_p, used_q = set(), set()
    for flat in np.argsort(gap, axis=None, kind="stable"):
        i, j = divmod(int(flat), gap.shape[1])
        if gap[i, j] > box_px:
            break
        if i in used_p or j in used_q:
            continue
        used_p.add(i)
        used_q.add(j)
        agree += abs(p_scores[i] - q_scores[j]) <= score_tol
    return agree


def _by_frame_class(entries):
    out = {}
    for t, box, c, s in entries:
        b, sc = out.setdefault((t, c), ([], []))
        b.append(box)
        sc.append(s)
    return out


def proto_entries(final_path: str) -> list:
    """A ``final.json``'s detections (frame ids 1..T) → (t, box, class, score)."""
    with open(final_path, encoding="utf-8") as f:
        proto = json.load(f)
    return [(int(d["frame"]) - 1, d["bbox"], int(s["class_index"]), float(s["score"]))
            for d in proto["detections"] for s in d["scores"]]


def array_entries(ref: dict, min_score: float) -> list:
    """Final arrays (``boxes`` (T, N, 4), ``mask`` (T, N), ``final``
    (C-1, T, N)) → (t, box, class, score) as ``final.json`` would list them."""
    fin = np.maximum(ref["final"], 0.0)
    return [(int(t), ref["boxes"][t, n].tolist(), int(c0) + 1, float(fin[c0, t, n]))
            for c0, t, n in zip(*np.nonzero((fin > min_score) & ref["mask"][None]))]


def final_dets(prog: list, ref: list, box_px: float, score_tol: float) -> dict:
    """Two videos' final detections → {"final_mismatch": share of detections
    on both sides without an agreeing partner, "final_dets": reference count}."""
    P, Q = _by_frame_class(prog), _by_frame_class(ref)
    agree = 0
    for key in set(P) & set(Q):
        agree += _pair_count(P[key][0], P[key][1], Q[key][0], Q[key][1], box_px, score_tol)
    total = len(prog) + len(ref)
    return {"final_mismatch": _share(total - 2 * agree, total), "final_dets": len(ref)}


def emissions(prog: dict, ref: dict, box_px: float, score_tol: float) -> dict:
    """The stream's arrays (``boxes`` (T, N, 4), ``scores`` and ``keep``
    (T, C-1, N), ``seq_scores`` (C-1, T, N)) against the reference's."""
    kp, kr = prog["keep"].astype(bool), ref["keep"].astype(bool)
    either = kp | kr
    box_gap = np.abs(prog["boxes"] - ref["boxes"]).max(-1)[:, None, :]  # (T, 1, N)
    bad = (kp != kr) | (box_gap > box_px) | (np.abs(prog["scores"] - ref["scores"]) > score_tol)
    seq_bad = np.abs(prog["seq_scores"] - ref["seq_scores"]) > score_tol  # (C-1, T, N)
    either_l = np.moveaxis(either, 1, 0)
    return {"emit_mismatch": _share(int((bad & either).sum()), int(either.sum())),
            "link_mismatch": _share(int((seq_bad & either_l).sum()), int(either_l.sum()))}


def stream_track_steps(tracks: dict, num_frames: int, chunk: int):
    """The recorded steps of the stream's tracks, each from the program's
    own previous state: a list of (seed frame, seed box, frame, box before,
    recorded box or None, recorded peak or None); None marks a track's end,
    where the step's peak must not exceed the termination threshold.

    A track's entries (frame, box, score) hold its seed (the first with a
    score above 0: the seeding detection's), the backtracked frames before
    it (score 0, within the seeding chunk's window of the chunk before and
    its own) and the tracked frames after it (score: the step's peak)."""
    steps = []
    for entries in tracks.values():
        entries = sorted(entries, key=lambda e: e[0])
        k = next(i for i, e in enumerate(entries) if e[2] > 0.0)
        ts, sb = entries[k][0], np.asarray(entries[k][1], np.float32)
        # a seed is first stepped at the next chunk's first frame
        prev, nxt_t = (ts, sb), (ts // chunk + 1) * chunk
        for t, box, peak in entries[k + 1:]:
            steps.append((ts, sb, t, prev[1], np.asarray(box, np.float32), peak))
            prev, nxt_t = (t, np.asarray(box, np.float32)), t + 1
        if nxt_t < num_frames:
            steps.append((ts, sb, nxt_t, prev[1], None, None))
        nxt = (ts, sb)
        for t, box, _ in reversed(entries[:k]):
            steps.append((ts, sb, t, nxt[1], np.asarray(box, np.float32), None))
            nxt = (t, np.asarray(box, np.float32))
        window_start = max((ts // chunk - 1) * chunk, 0)
        if nxt[0] - 1 >= window_start:
            steps.append((ts, sb, nxt[0] - 1, nxt[1], None, None))
    return steps


def fused_track_steps(boxes, conf, alive, n_tracks: int, t_valid: int, stride: int):
    """The steps of the fused engine's tracks (``track_boxes`` (K, T, 4),
    ``track_conf`` and ``track_alive`` (K, T) numpy, the first ``n_tracks``
    rows filled), as :func:`stream_track_steps` gives them, but with frames
    counted in samples of every ``stride``-th frame, the rows the tracker's
    features have.

    A track's anchor is its first frame of confidence 1; the scan starts at
    that frame's sample, rounded to the nearest one as the engine rounds it,
    and steps forward and backward one sample at a time, each from the box
    recorded at the sample before. A sample where the track is no longer
    alive is its end."""
    s = int(stride)
    last = (t_valid - 1) // s
    steps = []
    for k in range(int(n_tracks)):
        ones = np.nonzero(conf[k, :t_valid] == 1.0)[0]
        if not len(ones):
            continue
        t1 = int(ones[0])
        ats = min((t1 + s // 2) // s, last)
        sb = np.asarray(boxes[k, t1], np.float32)
        for order in (range(ats + 1, last + 1), range(ats - 1, -1, -1)):
            prev = sb
            for j in order:
                t = j * s
                if not alive[k, t]:
                    steps.append((ats, sb, j, prev, None, None))
                    break
                box = np.asarray(boxes[k, t], np.float32)
                steps.append((ats, sb, j, prev, box, float(conf[k, t])))
                prev = box
    return steps


def anchor_gap(boxes, conf, n_tracks: int, t_valid: int, cand_boxes, cand_mask) -> dict:
    """Each of the fused engine's tracks must start from an anchor candidate
    of the reference's (a kept detection at or above the anchor threshold):
    {"anchor_gap_px": the worst, over tracks, of the smallest box gap between
    the track's box at a frame of confidence 1 (its anchor frame and the
    sample the scan starts from) and a candidate of that frame}; 1e6 where a
    frame has no candidate."""
    worst = 0.0
    for k in range(int(n_tracks)):
        best = 1e6
        for t in np.nonzero(conf[k, :t_valid] == 1.0)[0]:
            c = cand_boxes[t][cand_mask[t]]
            if len(c):
                best = min(best, float(np.abs(c - boxes[k, t]).max(-1).min()))
        worst = max(worst, best)
    return {"anchor_gap_px": worst}


def track_steps(steps, boxes, peaks, conf_thresh: float) -> dict:
    """Recorded steps against the reference's recomputation (``boxes``,
    ``peaks`` one per step) → {"track_box_gap_px", "track_peak_gap",
    "track_steps"}."""
    box_gap, peak_gap = 0.0, 0.0
    for (_, _, _, _, rec_box, rec_peak), b, p in zip(steps, boxes, peaks):
        if rec_box is None:  # the track ended here: the step fails
            peak_gap = max(peak_gap, float(p) - conf_thresh)
            continue
        box_gap = max(box_gap, float(np.abs(b - rec_box).max()))
        if rec_peak is not None:
            peak_gap = max(peak_gap, abs(float(p) - float(rec_peak)))
    return {"track_box_gap_px": box_gap, "track_peak_gap": peak_gap, "track_steps": len(steps)}


def seeds(tracks: dict, prog: dict, seed_thresh: float) -> dict:
    """Each track's seed must be an emitted kept detection of its frame, with
    its best kept class score, at or above ``seed_thresh`` →
    {"seed_gap": worst box + score gap (0 when every seed is one)}."""
    best = np.where(prog["keep"], prog["scores"], 0.0).max(1)  # (T, N)
    worst = 0.0
    for entries in tracks.values():
        t, box, score = min((e for e in entries if e[2] > 0.0), key=lambda e: e[0])
        gaps = (np.abs(prog["boxes"][t] - np.asarray(box)).max(-1)
                + np.abs(best[t] - score))
        worst = max(worst, float(gaps.min()) + max(0.0, seed_thresh - score))
    return {"seed_gap": worst}
