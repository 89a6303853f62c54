"""Box operations on tensors (a frozen copy of the port's ``geometry/boxes.py``).

The op order of :func:`pairwise_iou` is the port's: NMS keep sets and
seq-NMS links are threshold decisions on its result.
"""

from __future__ import annotations

import torch

LEGACY_OFFSET = 1.0  # Fast R-CNN integer-pixel convention: w = x2 - x1 + 1


_DELTA_CLAMP = 4.135166556742356


def box_wh(boxes, offset: float = LEGACY_OFFSET):
    """Widths and heights of (..., 4) boxes."""
    w = boxes[..., 2] - boxes[..., 0] + offset
    h = boxes[..., 3] - boxes[..., 1] + offset
    return w, h


def box_area(boxes, offset: float = LEGACY_OFFSET):
    w, h = box_wh(boxes, offset)
    return w * h


def box_center(boxes, offset: float = LEGACY_OFFSET):
    w, h = box_wh(boxes, offset)
    cx = boxes[..., 0] + 0.5 * (w - offset)
    cy = boxes[..., 1] + 0.5 * (h - offset)
    return cx, cy


def pairwise_iou(boxes_a, boxes_b, offset: float = LEGACY_OFFSET):
    """IoU matrix between (..., Na, 4) and (..., Nb, 4) → (..., Na, Nb).

    Leading dims broadcast against each other."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(ix2 - ix1 + offset, min=0.0)
    ih = torch.clamp(iy2 - iy1 + offset, min=0.0)
    inter = iw * ih
    area_a = box_area(boxes_a, offset)[..., :, None]
    area_b = box_area(boxes_b, offset)[..., None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes, height, width, offset: float = LEGACY_OFFSET):
    """Clip (..., 4) boxes to image bounds [0, W-offset] × [0, H-offset]."""
    x1 = torch.clamp(boxes[..., 0], 0.0, width - offset)
    y1 = torch.clamp(boxes[..., 1], 0.0, height - offset)
    x2 = torch.clamp(boxes[..., 2], 0.0, width - offset)
    y2 = torch.clamp(boxes[..., 3], 0.0, height - offset)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def apply_deltas(boxes, deltas, offset: float = LEGACY_OFFSET):
    """Apply R-CNN regression deltas (..., 4) to boxes (..., 4)."""
    w, h = box_wh(boxes, offset)
    cx, cy = box_center(boxes, offset)
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = torch.clamp(deltas[..., 2], -_DELTA_CLAMP, _DELTA_CLAMP)
    dh = torch.clamp(deltas[..., 3], -_DELTA_CLAMP, _DELTA_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    x1 = pcx - 0.5 * (pw - offset)
    y1 = pcy - 0.5 * (ph - offset)
    x2 = pcx + 0.5 * (pw - offset)
    y2 = pcy + 0.5 * (ph - offset)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def shift_boxes(boxes, shift_xy):
    """Translate (..., 4) boxes by (..., 2) per-box (dx, dy) — the MGP shift."""
    dx, dy = shift_xy[..., 0], shift_xy[..., 1]
    return torch.stack(
        [boxes[..., 0] + dx, boxes[..., 1] + dy, boxes[..., 2] + dx, boxes[..., 3] + dy],
        dim=-1,
    )
