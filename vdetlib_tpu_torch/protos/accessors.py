"""Accessors over protocol dicts — the port's copy of what it calls from
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


def boxes_at_frame(box_proto: dict, frame_id: int) -> list[list[float]]:
    """All proposal bboxes at a frame, as [x1,y1,x2,y2] lists."""
    return [b["bbox"] for b in box_proto["boxes"] if b["frame"] == frame_id]


def dets_at_frame(det_proto: dict, frame_id: int) -> list[dict]:
    """The detection entries of one frame, in proto order."""
    return [d for d in det_proto["detections"] if d["frame"] == frame_id]


def det_class_indices(det_proto: dict) -> list[int]:
    """Sorted set of class indices present anywhere in the det_proto."""
    idxs = set()
    for d in det_proto["detections"]:
        for s in d["scores"]:
            idxs.add(int(s["class_index"]))
    return sorted(idxs)


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
