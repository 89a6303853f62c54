"""Visualization: detections and tracks drawn on frames, dumped as images —
the port's copy of ``vdetlib_tpu/utils/visual.py`` (the reference's
``vdetlib/utils/visual.py``): box + class + score overlays, a stable colour
per track or class. Used by the ``show_det`` / ``show_track`` tools.

``cv2`` is imported only when a box is drawn or a frame read or written; a
missing ``cv2`` raises a ``RuntimeError`` that names it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from vdetlib_tpu_torch.protos.accessors import dets_at_frame, frame_path_at
from vdetlib_tpu_torch.utils.common import cv2_module, imread, imwrite

_PALETTE_SEED = 0x9E3779B9


def unique_color(index: int) -> tuple[int, int, int]:
    """Deterministic, well-spread BGR colour for a track or class index
    (golden-ratio hashing, channels kept bright enough to read)."""
    h = (index * _PALETTE_SEED) & 0xFFFFFF
    b = 64 + (h & 0xFF) * 3 // 4
    g = 64 + ((h >> 8) & 0xFF) * 3 // 4
    r = 64 + ((h >> 16) & 0xFF) * 3 // 4
    return int(b), int(g), int(r)


def draw_box(img: np.ndarray, bbox: Sequence[float], label: Optional[str] = None,
             color: tuple[int, int, int] = (0, 220, 0), thickness: int = 2) -> np.ndarray:
    cv2 = cv2_module()
    x1, y1, x2, y2 = (int(round(float(v))) for v in bbox)
    cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness)
    if label:
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = max(y1 - 4, th + 2)
        cv2.rectangle(img, (x1, ty - th - 2), (x1 + tw + 2, ty + 2), color, -1)
        cv2.putText(img, label, (x1 + 1, ty), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return img


def draw_detections_on_frame(img: np.ndarray, dets: Sequence[dict],
                             score_thresh: float = 0.0) -> np.ndarray:
    for det in dets:
        for s in det["scores"]:
            if float(s["score"]) >= score_thresh:
                label = f"{s['class']}:{float(s['score']):.2f}"
                draw_box(img, det["bbox"], label, unique_color(int(s["class_index"])))
                break  # one label per box: its first class entry above the threshold
    return img


def show_detections(vid_proto: dict, det_proto: dict, out_dir: str,
                    score_thresh: float = 0.0) -> list[str]:
    """Dump annotated frames for a det_proto; returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fr in vid_proto["frames"]:
        img = imread(frame_path_at(vid_proto, fr["frame"]))
        draw_detections_on_frame(img, dets_at_frame(det_proto, fr["frame"]), score_thresh)
        out_path = os.path.join(out_dir, os.path.basename(fr["path"]))
        imwrite(out_path, img)
        written.append(out_path)
    return written


def show_tracks(vid_proto: dict, track_proto: dict, out_dir: str) -> list[str]:
    """Dump annotated frames with one stable colour per track."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fr in vid_proto["frames"]:
        img = imread(frame_path_at(vid_proto, fr["frame"]))
        for ti, track in enumerate(track_proto["tracks"]):
            boxes = track["boxes"] if isinstance(track, dict) else track
            for box in boxes:
                if box["frame"] == fr["frame"]:
                    label = f"t{ti}"
                    if "score" in box:
                        label += f":{float(box['score']):.2f}"
                    draw_box(img, box["bbox"], label, unique_color(ti))
                    break
        out_path = os.path.join(out_dir, os.path.basename(fr["path"]))
        imwrite(out_path, img)
        written.append(out_path)
    return written
