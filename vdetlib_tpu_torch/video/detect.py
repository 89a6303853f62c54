"""Frame-wise detection step — counterpart of ``vdetlib_tpu/video/detect.py``.

Backbone → ROI-align → head → softmax → per-class delta apply → clip, on a
batch of frames. Single scale at the frames' own size: the device resize
(``net_hw``), the image pyramid and the staged ``det_vid`` are not ported
yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.geometry.boxes import apply_deltas, clip_boxes
from vdetlib_tpu_torch.nn.detector import preprocess_images

__all__ = ["_detect_step"]


def _detect_step(model, images_u8, rois, regress: bool = True, net_hw=None):
    """(B, H, W, 3) u8 + (B, R, 4) rois → probs (B, R, K), boxes (B, R, K, 4)."""
    if net_hw is not None and tuple(net_hw) != tuple(images_u8.shape[1:3]):
        raise NotImplementedError(
            "on-device resize (net_hw) is not ported yet (ROADMAP.md, Queue 2 kernel E)"
        )
    images = preprocess_images(images_u8, model.config)
    scores, deltas = model(images, rois)
    probs = torch.softmax(scores, dim=-1)
    H, W = images_u8.shape[1:3]
    if regress:
        boxes = apply_deltas(rois[:, :, None, :], deltas)
    else:
        boxes = rois[:, :, None, :].expand(deltas.shape)
    return probs, clip_boxes(boxes, H, W)
