"""Frame-wise detection stage — counterpart of ``vdetlib_tpu/video/detect.py``.

Backbone → ROI-align → head → softmax → per-class delta apply → clip, on a
batch of frames (:func:`_detect_step`), optionally over an image pyramid
(:func:`_detect_step_pyramid`), and the staged stage over protos
(:func:`det_vid`). With ``net_hw`` the frames arrive at their native size
and are resized on the device by ``kernels/preprocess.py`` (kernel E on the
card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.geometry.boxes import apply_deltas, clip_boxes
from vdetlib_tpu_torch.kernels.preprocess import fused_resize_normalize_kernel
from vdetlib_tpu_torch.nn.detector import preprocess_images
from vdetlib_tpu_torch.protos.accessors import boxes_at_frame
from vdetlib_tpu_torch.utils.log import StageMetrics

__all__ = ["DetectOptions", "_detect_step", "_detect_step_pyramid", "det_vid", "detect_arrays"]


@dataclass(frozen=True)
class DetectOptions:
    """Same fields and defaults as the JAX ``DetectOptions``."""

    batch_size: int = 8
    max_rois: int = 128
    image_hw: tuple = (240, 320)  # static network input (H, W)
    score_thresh: float = 0.005  # drop per-class entries below this
    regress: bool = True  # apply per-class bbox regression
    class_names: Optional[tuple] = None
    # resize on the device: frames are read at their native size and cross
    # to the device as uint8; requires one native frame size per video
    device_resize: bool = False
    # image pyramid: each entry scales the network input; per-box scores are
    # max-pooled over scales. (1.0,) = single scale.
    pyramid: tuple = (1.0,)


def _detect_step(model, images_u8, rois, regress: bool = True, net_hw=None):
    """(B, H, W, 3) u8 + (B, R, 4) rois → probs (B, R, K), boxes (B, R, K, 4).

    With ``net_hw`` other than the frames' size, the frames are resized to
    it on the device (``rois`` must already be in network coordinates) and
    the boxes are clipped to it."""
    if net_hw is not None and tuple(net_hw) != tuple(images_u8.shape[1:3]):
        cfg = model.config
        images = fused_resize_normalize_kernel(images_u8, tuple(net_hw), cfg.pixel_mean,
                                               cfg.pixel_scale)
    else:
        images = preprocess_images(images_u8, model.config)
    scores, deltas = model(images, rois)
    probs = torch.softmax(scores, dim=-1)
    H, W = net_hw if net_hw is not None else images_u8.shape[1:3]
    if regress:
        boxes = apply_deltas(rois[:, :, None, :], deltas)
    else:
        boxes = rois[:, :, None, :].expand(deltas.shape)
    return probs, clip_boxes(boxes, H, W)


def _detect_step_pyramid(model, images_u8, rois, regress: bool, pyramid: tuple, net_hw=None):
    """Multi-scale detection: run the net at each pyramid scale and max-pool.

    Each scale's input size is the base size (``net_hw`` or the frames' own)
    times the scale, rounded to a multiple of 16; the rois are scaled with it
    and the boxes scaled back. Scores are per-(box, class) maxima over scales;
    boxes come from the best-scoring scale (the first maximum)."""
    base_hw = tuple(net_hw) if net_hw is not None else tuple(images_u8.shape[1:3])
    all_probs, all_boxes = [], []
    for s in pyramid:
        hw = (
            max(int(round(base_hw[0] * s / 16)) * 16, 16),
            max(int(round(base_hw[1] * s / 16)) * 16, 16),
        )
        sc = torch.tensor([hw[1] / base_hw[1], hw[0] / base_hw[0]] * 2, dtype=torch.float32,
                          device=rois.device)  # per-axis [sx, sy, sx, sy]
        probs_s, boxes_s = _detect_step(model, images_u8, rois * sc, regress, net_hw=hw)
        all_probs.append(probs_s)
        all_boxes.append(boxes_s / sc)  # back to base scale
    probs = torch.stack(all_probs)  # (S, B, R, K)
    boxes = torch.stack(all_boxes)
    best = torch.argmax(probs, dim=0)  # (B, R, K), first maximum
    probs = torch.amax(probs, dim=0)
    boxes = torch.gather(boxes, 0, best[None, ..., None].expand((1,) + best.shape + (4,)))[0]
    return probs, boxes


@torch.no_grad()
def detect_arrays(model, frames_u8, rois, roi_mask, opts: DetectOptions):
    """In-memory detection over (T, H, W, 3) frames at the network size.

    ``rois`` (T, R, 4) padded proposals in network pixel space, ``roi_mask``
    (T, R) bool. Returns probs (T, R, K) and boxes (T, R, K, 4) numpy arrays;
    the batches are padded by repeating their last frame."""
    dev = next(model.parameters()).device
    T = frames_u8.shape[0]
    B = opts.batch_size
    probs_out, boxes_out = [], []
    for start in range(0, T, B):
        idx = np.arange(start, min(start + B, T))
        pad = B - len(idx)
        sel = np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx
        p, b = _detect_step(model, torch.from_numpy(frames_u8[sel]).to(dev),
                            torch.from_numpy(rois[sel]).to(dev), opts.regress)
        probs_out.append(p[:len(idx)].cpu().numpy())
        boxes_out.append(b[:len(idx)].cpu().numpy())
    probs = np.concatenate(probs_out, axis=0)
    boxes = np.concatenate(boxes_out, axis=0)
    return probs * roi_mask[..., None], boxes


@torch.no_grad()
def det_vid(model, vid_proto: dict, box_proto: dict, opts: DetectOptions = DetectOptions(),
            frames_u8: Optional[np.ndarray] = None) -> dict:
    """Full detection stage: vid_proto + box_proto → det_proto.

    One detection entry per (proposal, class >= 1) whose probability clears
    ``score_thresh``, carrying that class's regressed box in the pixel space
    of the ORIGINAL frames, in (frame, proposal, class) order. A batch's
    entries are emitted after the next batch has been dispatched.
    ``frames_u8`` (T, H, W, 3) uint8 skips the frame files: native frames
    with ``device_resize``, else frames at ``image_hw``."""
    metrics = StageMetrics("detect")
    dev = next(model.parameters()).device
    loader = FrameLoader(vid_proto, target_hw=None if opts.device_resize else opts.image_hw,
                         frames=frames_u8)
    R = opts.max_rois
    K = model.config.num_classes
    detections = []
    n_frames = 0

    def emit(fids, scales, mask, probs_dev, boxes_dev):
        # the host copy waits for the device; by now the next batch is queued
        probs = probs_dev.cpu().numpy()[:len(fids)]
        boxes = boxes_dev.cpu().numpy()[:len(fids)]
        inv = np.array([[1 / sx, 1 / sy, 1 / sx, 1 / sy] for sy, sx in scales], dtype=np.float32)
        # compared as Python floats, as the JAX stage's per-entry test does
        hit = mask[:len(fids), :, None] & (probs.astype(np.float64) >= opts.score_thresh)
        hit[:, :, 0] = False  # background
        for bi, ri, ci in zip(*np.nonzero(hit)):  # (frame, proposal, class) order
            name = opts.class_names[ci] if opts.class_names is not None else str(ci)
            detections.append({
                "frame": int(fids[bi]),
                "bbox": [float(v) for v in boxes[bi, ri, ci] * inv[bi]],
                "scores": [{"class": name, "class_index": int(ci),
                            "score": float(probs[bi, ri, ci])}],
            })

    pending = None
    for fids, images, scales in loader.iter_batches(opts.batch_size):
        B = images.shape[0]
        if opts.device_resize:
            h, w = images.shape[1:3]
            scales = [(opts.image_hw[0] / h, opts.image_hw[1] / w)] * len(fids)
        rois = np.zeros((B, R, 4), dtype=np.float32)
        mask = np.zeros((B, R), dtype=bool)
        for bi, fid in enumerate(fids):
            sy, sx = scales[bi]
            props = boxes_at_frame(box_proto, fid)[:R]
            for ri, bb in enumerate(props):
                rois[bi, ri] = [bb[0] * sx, bb[1] * sy, bb[2] * sx, bb[3] * sy]
                mask[bi, ri] = True
        net_hw = tuple(opts.image_hw) if opts.device_resize else None
        images_d = torch.from_numpy(images).to(dev)
        rois_d = torch.from_numpy(rois).to(dev)
        if tuple(opts.pyramid) != (1.0,):
            probs_dev, boxes_dev = _detect_step_pyramid(
                model, images_d, rois_d, opts.regress, tuple(opts.pyramid),
                net_hw=net_hw or tuple(opts.image_hw),
            )
        else:
            probs_dev, boxes_dev = _detect_step(model, images_d, rois_d, opts.regress,
                                                net_hw=net_hw)
        if pending is not None:
            emit(*pending)
        pending = (fids, scales, mask, probs_dev, boxes_dev)
        n_frames += len(fids)
    if pending is not None:
        emit(*pending)
    loader.close()
    metrics.set("frames", n_frames)
    metrics.set("dets_out", len(detections))
    metrics.finish()
    return {"video": vid_proto["video"], "detections": detections}
