"""Host-side numpy/cv2 helpers — the port's copy of ``vdetlib_tpu/utils/common.py``
(same names, same behaviour): pairwise ``iou``, BGR ``imread``/``imwrite``,
natural sort and temporal windows. ``cv2`` is imported only when an image is
read or written, so the package imports on a machine without it."""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET


def iou(boxes_a, boxes_b, offset: float = LEGACY_OFFSET) -> np.ndarray:
    """Pairwise IoU matrix (Na, Nb) in float64 numpy, with the Fast R-CNN
    ``+1`` width convention (the reference's vectorized ``common.iou``)."""
    a = np.asarray(boxes_a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, dtype=np.float64).reshape(-1, 4)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    iw = np.maximum(ix2 - ix1 + offset, 0.0)
    ih = np.maximum(iy2 - iy1 + offset, 0.0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + offset) * (a[:, 3] - a[:, 1] + offset)
    area_b = (b[:, 2] - b[:, 0] + offset) * (b[:, 3] - b[:, 1] + offset)
    union = area_a[:, None] + area_b[None, :] - inter
    out = np.zeros_like(inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


def cv2_module():
    """``cv2``, or a ``RuntimeError`` that names it when it is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 (opencv-python) is not installed: reading, drawing and "
                           "writing images needs it") from e
    return cv2


def imread(path: str) -> np.ndarray:
    """Read an image as BGR uint8 (the reference's Caffe-era convention)."""
    cv2 = cv2_module()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return img


def imwrite(path: str, img: np.ndarray) -> None:
    cv2 = cv2_module()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not cv2.imwrite(path, img):
        raise IOError(f"cannot write image: {path}")


_NAT_SPLIT = re.compile(r"(\d+)")


def natural_sort(items: Sequence[str]) -> list[str]:
    """Sort strings with embedded integers numerically (frame_2 < frame_10)."""

    def key(s: str):
        return [int(p) if p.isdigit() else p for p in _NAT_SPLIT.split(s)]

    return sorted(items, key=key)


def temporal_windows(frame_ids: Sequence[int], window: int) -> list[list[int]]:
    """Sliding windows of ±window around each frame, clipped to the video
    (for frame t, the frames MGP-style propagation reaches)."""
    ids = list(frame_ids)
    id_set = set(ids)
    return [[g for g in range(f - window, f + window + 1) if g in id_set] for f in ids]
