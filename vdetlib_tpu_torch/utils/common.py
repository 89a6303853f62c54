"""Host-side numpy helpers — the port's copy of what it calls from
``vdetlib_tpu/utils/common.py`` (same names, same behaviour)."""

from __future__ import annotations

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
