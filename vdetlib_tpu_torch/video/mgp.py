"""Motion-guided propagation (MGP) — counterpart of ``vdetlib_tpu/video/mgp.py``.

For each detection at frame t, the mean flow inside its box shifts it into
the neighbouring frames t±1..±w (with its class scores, decayed per hop),
and a per-frame per-class NMS dedups the union of native and propagated
detections. The flow over the whole video, forward and on the flipped
frames, is two calls of ``kernels/flow.py::flow_video`` (kernel A on the
card); each hop is one batched shift-by-mean-flow over the (T, N) boxes on
the device, and the hops compose with no host synchronisation between them.
Scores shift on the host, as in the JAX package; the dedup is the host
frame NMS (``frame_nms(backend="host")``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.geometry.boxes import shift_boxes
from vdetlib_tpu_torch.kernels.flow import flow_coord_scale, flow_video, mean_flow_in_boxes
from vdetlib_tpu_torch.protos.accessors import frame_ids as get_frame_ids
from vdetlib_tpu_torch.protos.arrays import arrays_to_det_proto, det_proto_to_arrays
from vdetlib_tpu_torch.utils.log import StageMetrics
from vdetlib_tpu_torch.video.frame_nms import frame_nms

__all__ = ["MGPOptions", "_propagate_hop", "mgp", "propagate_dets"]


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


@torch.no_grad()
def propagate_dets(frames_u8, boxes, scores, mask, opts: MGPOptions, device="cuda"):
    """Pure-array MGP core, on ``device`` (the card unless the caller asks
    for the CPU, where kernel A's plain version runs).

    Args:
      frames_u8: (T, H, W, 3) uint8; boxes: (T, N, 4); scores: (T, N, C);
      mask: (T, N) bool — numpy arrays.
    Returns:
      numpy (boxes', scores', mask', origin_hop) with N' = N * (2*window + 1)
      — slot blocks [native, +1, ..., +w, -1, ..., -w].
    """
    dev = torch.device(device)
    T, N = mask.shape
    w = opts.window
    # reduced-res presets read the flow grid directly (values in full-res
    # px; boxes scale by 1/pool onto the grid)
    coord_scale = flow_coord_scale(opts.flow_preset)
    flow_kw = dict(levels=opts.flow_levels, search=opts.flow_search, preset=opts.flow_preset,
                   upsample=(coord_scale == 1.0))
    frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(dev)
    fwd = flow_video(frames, **flow_kw)  # (T-1, h, w, 2): t → t+1
    # on the reversed video index r maps rev r → r+1, i.e. orig T-1-r → T-2-r;
    # flipped back, bwd[t] maps t+1 → t
    bwd = torch.flip(flow_video(torch.flip(frames, dims=(0,)), **flow_kw), dims=(0,))

    b0 = torch.from_numpy(np.ascontiguousarray(boxes, dtype=np.float32)).to(dev)
    m0 = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(dev)
    zb, zm = b0.new_zeros((1, N, 4)), m0.new_zeros((1, N))
    out_boxes, out_mask = [b0], [m0]
    out_scores = [scores]
    hops = [np.zeros((T, N), np.int32)]
    # forward hops: after hop h slot t holds the det propagated from t-h
    cur_b, cur_m = b0, m0
    for h in range(1, w + 1):
        nb = _propagate_hop(fwd, cur_b[:-1], cur_m[:-1], coord_scale)  # (T-1, N, 4)
        cur_b = torch.cat([zb, nb])
        cur_m = torch.cat([zm, cur_m[:-1]])
        src = np.zeros_like(scores)
        src[h:] = scores[:-h]
        out_boxes.append(cur_b)
        out_mask.append(cur_m)
        out_scores.append(src * (opts.score_decay ** h))
        hops.append(np.full((T, N), h, np.int32))
    # backward hops: dets from t land at t-h
    cur_b, cur_m = b0, m0
    for h in range(1, w + 1):
        nb = _propagate_hop(bwd, cur_b[1:], cur_m[1:], coord_scale)  # (T-1, N, 4) → t
        cur_b = torch.cat([nb, zb])
        cur_m = torch.cat([cur_m[1:], zm])
        src = np.zeros_like(scores)
        src[:-h] = scores[h:]
        out_boxes.append(cur_b)
        out_mask.append(cur_m)
        out_scores.append(src * (opts.score_decay ** h))
        hops.append(np.full((T, N), -h, np.int32))

    return (
        torch.cat(out_boxes, dim=1).cpu().numpy(),
        np.concatenate(out_scores, axis=1),
        torch.cat(out_mask, dim=1).cpu().numpy(),
        np.concatenate(hops, axis=1),
    )


def mgp(vid_proto: dict, det_proto: dict, opts: MGPOptions = MGPOptions(),
        frames_u8: Optional[np.ndarray] = None, device="cuda") -> dict:
    """Full MGP stage: vid_proto + det_proto → det_proto (densified).

    ``frames_u8`` (T, H, W, 3) uint8 skips the frame files (the card's
    machine has no ``cv2``); the flow and the hops run on ``device``."""
    metrics = StageMetrics("mgp")
    fids = get_frame_ids(vid_proto)
    if frames_u8 is None:
        loader = FrameLoader(vid_proto, target_hw=opts.image_hw)
        frames_u8 = np.stack([img for _, img, _ in loader.iter_frames()])
        loader.close()
    boxes, scores, mask = det_proto_to_arrays(det_proto, fids, opts.max_boxes, opts.num_classes)
    b2, s2, m2, _ = propagate_dets(frames_u8, boxes, scores, mask, opts, device=device)
    out = arrays_to_det_proto(b2, s2, m2, fids, vid_proto["video"], score_thresh=0.0)
    if opts.run_nms:
        out = frame_nms(vid_proto, out, thresh=opts.nms_thresh, backend="host")
    metrics.set("frames", len(fids))
    metrics.set("dets_in", len(det_proto["detections"]))
    metrics.set("dets_out", len(out["detections"]))
    metrics.finish()
    return out
