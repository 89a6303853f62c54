"""Motion-guided propagation hop — counterpart of ``vdetlib_tpu/video/mgp.py``.

Each detection box is shifted by the mean flow inside it; the staged MGP
stage (``propagate_dets``/``mgp``) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from vdetlib_tpu_torch.geometry.boxes import shift_boxes
from vdetlib_tpu_torch.kernels.flow import mean_flow_in_boxes

__all__ = ["_propagate_hop"]


def _propagate_hop(flow_t, boxes_t, mask_t, coord_scale: float = 1.0):
    """One hop: boxes at t shifted by their mean flow → boxes for t+1.

    flow_t: (..., h, w, 2) flow grid whose VALUES are full-res pixels;
    boxes_t: (..., N, 4) full-res; mask_t: (..., N). ``coord_scale`` maps box
    coordinates onto the flow grid (1/4 for the "fastest" preset).
    """
    shift = mean_flow_in_boxes(flow_t, boxes_t * coord_scale, mask_t)
    return shift_boxes(boxes_t, shift)
