"""Motion-guided propagation hop — counterpart of ``vdetlib_tpu/video/mgp.py``.

Each detection box is shifted by the mean flow inside it. ``MGPOptions``
holds the stage's options (the pipeline config tree reads them); the staged
MGP stage (``propagate_dets``/``mgp``) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from vdetlib_tpu_torch.geometry.boxes import shift_boxes
from vdetlib_tpu_torch.kernels.flow import mean_flow_in_boxes

__all__ = ["MGPOptions", "_propagate_hop"]


@dataclass(frozen=True)
class MGPOptions:
    """Same fields and defaults as the JAX ``MGPOptions``."""

    window: int = 1  # propagate to t±window
    score_decay: float = 0.9  # per-hop multiplicative decay on copied scores
    nms_thresh: float = 0.3  # dedup NMS threshold
    max_boxes: int = 64  # per-frame detection budget (pre-propagation)
    num_classes: int = 31
    flow_levels: int = 3
    flow_search: int = 3
    flow_preset: str = "fastest"  # "fastest" quarter res, "fast" half, "accurate" pyramid
    image_hw: Optional[tuple] = None
    run_nms: bool = True


def _propagate_hop(flow_t, boxes_t, mask_t, coord_scale: float = 1.0):
    """One hop: boxes at t shifted by their mean flow → boxes for t+1.

    flow_t: (..., h, w, 2) flow grid whose VALUES are full-res pixels;
    boxes_t: (..., N, 4) full-res; mask_t: (..., N). ``coord_scale`` maps box
    coordinates onto the flow grid (1/4 for the "fastest" preset).
    """
    shift = mean_flow_in_boxes(flow_t, boxes_t * coord_scale, mask_t)
    return shift_boxes(boxes_t, shift)
