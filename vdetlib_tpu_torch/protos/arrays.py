"""Proto ⇄ padded-array bridges — the port's copy of what it calls from
``vdetlib_tpu/protos/arrays.py`` (same names, same behaviour).

Padding convention: invalid slots are all-zero boxes with score 0.0 and
``mask == False``; kernels honour the mask, never the sentinel values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _frame_index_map(frame_ids: Sequence[int]) -> dict[int, int]:
    return {int(f): i for i, f in enumerate(frame_ids)}


def box_proto_to_arrays(box_proto: dict, frame_ids: Sequence[int],
                        max_boxes: int) -> tuple[np.ndarray, np.ndarray]:
    """box_proto → (boxes[T, N, 4] f32, mask[T, N] bool); file order, first
    ``max_boxes`` per frame."""
    T = len(frame_ids)
    fmap = _frame_index_map(frame_ids)
    boxes = np.zeros((T, max_boxes, 4), dtype=np.float32)
    mask = np.zeros((T, max_boxes), dtype=bool)
    counts = np.zeros(T, dtype=np.int64)
    for b in box_proto["boxes"]:
        t = fmap.get(int(b["frame"]))
        if t is None:
            continue
        n = counts[t]
        if n >= max_boxes:
            continue
        boxes[t, n] = np.asarray(b["bbox"], dtype=np.float32)
        mask[t, n] = True
        counts[t] += 1
    return boxes, mask


def det_proto_to_arrays(det_proto: dict, frame_ids: Sequence[int], max_boxes: int,
                        num_classes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """det_proto → (boxes[T, N, 4], scores[T, N, C], mask[T, N]).

    ``scores[..., c]`` holds the score of ``class_index == c`` (0 when
    absent); detections beyond ``max_boxes`` per frame are dropped in file
    order."""
    T = len(frame_ids)
    fmap = _frame_index_map(frame_ids)
    boxes = np.zeros((T, max_boxes, 4), dtype=np.float32)
    scores = np.zeros((T, max_boxes, num_classes), dtype=np.float32)
    mask = np.zeros((T, max_boxes), dtype=bool)
    counts = np.zeros(T, dtype=np.int64)
    for d in det_proto["detections"]:
        t = fmap.get(int(d["frame"]))
        if t is None:
            continue
        n = counts[t]
        if n >= max_boxes:
            continue
        boxes[t, n] = np.asarray(d["bbox"], dtype=np.float32)
        for s in d["scores"]:
            ci = int(s["class_index"])
            if 0 <= ci < num_classes:
                scores[t, n, ci] = float(s["score"])
        mask[t, n] = True
        counts[t] += 1
    return boxes, scores, mask


def arrays_to_det_proto(boxes, scores, mask, frame_ids: Sequence[int], video: str,
                        class_names: Optional[Sequence[str]] = None,
                        score_thresh: float = float("-inf"),
                        skip_class_zero: bool = True) -> dict:
    """(boxes[T,N,4], scores[T,N,C], mask[T,N]) → det_proto.

    Class 0 is background (skipped unless ``skip_class_zero`` is False).
    Score entries at or below ``score_thresh`` are omitted; a detection with
    no surviving entry is dropped."""
    boxes = np.asarray(boxes)
    scores = np.asarray(scores)
    mask = np.asarray(mask)
    T, N, C = scores.shape
    first_class = 1 if skip_class_zero else 0
    detections = []
    for t, frame_id in enumerate(frame_ids):
        for n in range(N):
            if not mask[t, n]:
                continue
            entry_scores = []
            for c in range(first_class, C):
                sc = float(scores[t, n, c])
                if sc > score_thresh:
                    name = class_names[c] if class_names is not None else str(c)
                    entry_scores.append({"class": name, "class_index": c, "score": sc})
            if entry_scores:
                detections.append({
                    "frame": int(frame_id),
                    "bbox": [float(v) for v in boxes[t, n]],
                    "scores": entry_scores,
                })
    return {"video": video, "detections": detections}


def _track_boxes(track):
    """A track's boxes: tracks are lists of boxes, or score_proto dicts
    ``{"boxes": [...], ...}``."""
    return track["boxes"] if isinstance(track, dict) else track


def track_proto_to_arrays(track_proto: dict, frame_ids: Sequence[int],
                          max_tracks: Optional[int] = None
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """track_proto → (boxes[K, T, 4], scores[K, T], mask[K, T]); the first
    ``max_tracks`` tracks."""
    tracks = track_proto["tracks"]
    if max_tracks is not None:
        tracks = tracks[:max_tracks]
    K, T = len(tracks), len(frame_ids)
    fmap = _frame_index_map(frame_ids)
    boxes = np.zeros((K, T, 4), dtype=np.float32)
    scores = np.zeros((K, T), dtype=np.float32)
    mask = np.zeros((K, T), dtype=bool)
    for k, track in enumerate(tracks):
        for box in _track_boxes(track):
            t = fmap.get(int(box["frame"]))
            if t is None:
                continue
            boxes[k, t] = np.asarray(box["bbox"], dtype=np.float32)
            scores[k, t] = float(box.get("score", 0.0))
            mask[k, t] = True
    return boxes, scores, mask


def track_cls_scores_to_arrays(track_proto: dict, frame_ids: Sequence[int], num_classes: int,
                               max_tracks: Optional[int] = None) -> tuple[np.ndarray, bool]:
    """Each track box's ``perturb_scores`` (written by the perturbation
    stage, ``video/perturb.py``) → ((K, T, C) float32, found_any); absent
    entries are zeros, and ``found_any`` is False when no box carries one."""
    tracks = track_proto["tracks"]
    if max_tracks is not None:
        tracks = tracks[:max_tracks]
    K, T = len(tracks), len(frame_ids)
    fmap = _frame_index_map(frame_ids)
    out = np.zeros((K, T, num_classes), dtype=np.float32)
    found = False
    for k, track in enumerate(tracks):
        for box in _track_boxes(track):
            t = fmap.get(int(box["frame"]))
            if t is None:
                continue
            for s in box.get("perturb_scores", []):
                ci = int(s["class_index"])
                if 0 <= ci < num_classes:
                    out[k, t, ci] = float(s["score"])
                    found = True
    return out, found


def arrays_to_track_proto(boxes, scores, mask, frame_ids: Sequence[int], video: str, method: str,
                          anchors: Optional[Sequence[int]] = None) -> dict:
    """(boxes[K, T, 4], scores[K, T], mask[K, T]) → track_proto; a track with
    no live frame is dropped."""
    boxes = np.asarray(boxes)
    scores = np.asarray(scores)
    mask = np.asarray(mask)
    K, T = mask.shape
    tracks = []
    for k in range(K):
        entries = []
        for t in range(T):
            if not mask[k, t]:
                continue
            e = {"frame": int(frame_ids[t]), "bbox": [float(v) for v in boxes[k, t]],
                 "score": float(scores[k, t])}
            if anchors is not None:
                e["anchor"] = int(anchors[k])
            entries.append(e)
        if entries:
            tracks.append(entries)
    return {"video": video, "method": method, "tracks": tracks}
