"""Accessors over protocol dicts — the port's copy of
``vdetlib_tpu/protos/accessors.py`` (same names, same behaviour).

Schemas: ``vid_proto`` {video, root_path, frames: [{frame (1-based), path}]};
``box_proto`` {video, boxes: [{frame, bbox}]}; ``det_proto`` {video,
detections: [{frame, bbox, scores: [{class, class_index, score}]}]};
``track_proto`` {video, method, tracks: [[{frame, bbox, ...per-box meta}]]}.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence


def _frame_entry(vid_proto: dict, frame_id: int) -> dict:
    for fr in vid_proto["frames"]:
        if fr["frame"] == frame_id:
            return fr
    raise KeyError(f"frame {frame_id} not in vid_proto {vid_proto.get('video')}")


def frame_ids(vid_proto: dict) -> list[int]:
    return [fr["frame"] for fr in vid_proto["frames"]]


def frame_path_at(vid_proto: dict, frame_id: int) -> str:
    """Absolute path of frame ``frame_id`` (frames are 1-based)."""
    fr = _frame_entry(vid_proto, frame_id)
    return os.path.join(vid_proto["root_path"], fr["path"])


def frame_path_before(vid_proto: dict, frame_id: int) -> str:
    """Path of the closest frame with id < frame_id (or frame_id itself)."""
    cands = [fr["frame"] for fr in vid_proto["frames"] if fr["frame"] <= frame_id]
    if not cands:
        raise KeyError(f"no frame at or before {frame_id}")
    return frame_path_at(vid_proto, max(cands))


def frame_path_after(vid_proto: dict, frame_id: int) -> str:
    """Path of the closest frame with id > frame_id (or frame_id itself)."""
    cands = [fr["frame"] for fr in vid_proto["frames"] if fr["frame"] >= frame_id]
    if not cands:
        raise KeyError(f"no frame at or after {frame_id}")
    return frame_path_at(vid_proto, min(cands))


def boxes_at_frame(box_proto: dict, frame_id: int) -> list[list[float]]:
    """All proposal bboxes at a frame, as [x1,y1,x2,y2] lists."""
    return [b["bbox"] for b in box_proto["boxes"] if b["frame"] == frame_id]


def dets_at_frame(det_proto: dict, frame_id: int) -> list[dict]:
    """The detection entries of one frame, in proto order."""
    return [d for d in det_proto["detections"] if d["frame"] == frame_id]


def det_boxes_at_frame(det_proto: dict, frame_id: int) -> list[list[float]]:
    return [d["bbox"] for d in dets_at_frame(det_proto, frame_id)]


def det_score(det: dict, class_index: int) -> float:
    """Score of one class for one detection entry (0.0 when absent)."""
    for s in det["scores"]:
        if s["class_index"] == class_index:
            return float(s["score"])
    return 0.0


def det_scores_at_frame(det_proto: dict, frame_id: int, class_index: int) -> list[float]:
    return [det_score(d, class_index) for d in dets_at_frame(det_proto, frame_id)]


def det_class_indices(det_proto: dict) -> list[int]:
    """Sorted set of class indices present anywhere in the det_proto."""
    idxs = set()
    for d in det_proto["detections"]:
        for s in d["scores"]:
            idxs.add(int(s["class_index"]))
    return sorted(idxs)


def empty_det_from_box(bbox: Sequence[float], frame_id: int) -> dict:
    """A detection entry with a box but no class scores yet."""
    return {"frame": int(frame_id), "bbox": [float(v) for v in bbox], "scores": []}


def top_detections(det_proto: dict, top_k: int, class_index: Optional[int] = None) -> list[dict]:
    """The ``top_k`` highest-scoring detections (of ``class_index``, or by
    their best class), stable for ties."""

    def best(d: dict) -> float:
        if class_index is not None:
            return det_score(d, class_index)
        return max((float(s["score"]) for s in d["scores"]), default=float("-inf"))

    return sorted(det_proto["detections"], key=best, reverse=True)[:top_k]


def tracks_at_frame(track_proto: dict, frame_id: int) -> list[dict]:
    """The per-frame box dict of every track that covers ``frame_id``."""
    out = []
    for track in track_proto["tracks"]:
        for box in track:
            if box["frame"] == frame_id:
                out.append(box)
                break
    return out


def track_box_at_frame(track: list[dict], frame_id: int) -> Optional[list[float]]:
    """bbox of one track at a frame, or None when the track skips it."""
    for box in track:
        if box["frame"] == frame_id:
            return box["bbox"]
    return None


def tracks_proto_from_boxes(
    per_track_boxes: Iterable[Iterable[tuple[int, Sequence[float], float]]],
    video: str,
    method: str = "vdetlib_tpu_tracker",
    anchors: Optional[Sequence[int]] = None,
) -> dict:
    """Build a track_proto from per-track (frame, bbox, score) tuples.

    Each track's boxes are sorted by frame; ``anchor`` metadata marks the seed
    frame; a track with no box is dropped."""
    tracks = []
    for ti, boxes in enumerate(per_track_boxes):
        entries = []
        for frame_id, bbox, score in boxes:
            e = {"frame": int(frame_id), "bbox": [float(v) for v in bbox], "score": float(score)}
            if anchors is not None:
                e["anchor"] = int(anchors[ti])
            entries.append(e)
        entries.sort(key=lambda e: e["frame"])
        if entries:
            tracks.append(entries)
    return {"video": video, "method": method, "tracks": tracks}


def score_proto_from_track_proto(track_proto: dict, per_track_class_scores: Sequence[dict],
                                 method: str = "tubelet_rescore") -> dict:
    """Attach per-class tubelet statistics to a track_proto → score_proto.

    ``per_track_class_scores[i]`` maps ``class_index`` → statistic for track
    i. Each track becomes ``{"boxes": [...], "scores": [{class_index,
    score}]}`` (classes ascending); the proto keeps ``video`` and records the
    track_proto's method as ``base_method``."""
    if len(per_track_class_scores) != len(track_proto["tracks"]):
        raise ValueError("one class-score dict required per track")
    out_tracks = []
    for track, cls_scores in zip(track_proto["tracks"], per_track_class_scores):
        out_tracks.append({
            "boxes": [dict(b) for b in track],
            "scores": [{"class_index": int(ci), "score": float(sc)}
                       for ci, sc in sorted(cls_scores.items())],
        })
    return {"video": track_proto["video"], "method": method,
            "base_method": track_proto.get("method"), "tracks": out_tracks}
