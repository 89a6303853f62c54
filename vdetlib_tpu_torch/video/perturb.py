"""Tubelet box perturbation + max-pooling rescoring — counterpart of
``vdetlib_tpu/video/perturb.py``.

Around each tubelet box, perturbed boxes (scale and translation jitter) are
scored by the detector and max-pooled: the box takes the per-class maximum
over its perturbations, and optionally moves to the best one. The jitter is
drawn from the port's copy of JAX's key stream (``utils/prng.py``), so the
same ``seed`` perturbs the same boxes as the JAX package; the detector runs
under ``torch.no_grad()`` on the model's device, ``batch_frames`` frames a
call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import box_center, box_wh, clip_boxes
from vdetlib_tpu_torch.nn.detector import preprocess_images
from vdetlib_tpu_torch.protos.arrays import track_proto_to_arrays
from vdetlib_tpu_torch.utils import prng

__all__ = ["PerturbOptions", "perturb_boxes", "perturb_rescore_arrays",
           "perturb_rescore_track_proto"]


@dataclass(frozen=True)
class PerturbOptions:
    """Same fields and defaults as the JAX ``PerturbOptions``."""

    num_perturb: int = 8  # perturbations per tubelet box (incl. identity)
    shift_sigma: float = 0.05  # stddev of center shift, in box-size units
    scale_sigma: float = 0.10  # stddev of log-scale jitter
    take_best_box: bool = True  # move the tubelet box to the best perturbation
    seed: int = 0


def perturb_boxes(boxes, key, opts: PerturbOptions, height, width, noise=None):
    """(..., 4) boxes → (..., P, 4) perturbed (the first one is the identity).

    The standard normals of the x shift, y shift and log scale are ``noise``
    (three tensors of shape (..., P)), or drawn from ``key`` (a raw key of
    ``utils/prng.py``) as ``jax.random`` draws them from a split of ``key``
    in three."""
    P = opts.num_perturb
    shape = tuple(boxes.shape[:-1]) + (P,)
    if noise is None:
        noise = [torch.from_numpy(prng.normal(k, shape)).to(boxes.device)
                 for k in prng.split(key, 3)]
    nx, ny, ns = noise
    identity = torch.zeros(shape, dtype=boxes.dtype, device=boxes.device)
    identity[..., 0] = 1.0
    dx = nx * opts.shift_sigma * (1 - identity)
    dy = ny * opts.shift_sigma * (1 - identity)
    ds = torch.exp(ns * opts.scale_sigma) * (1 - identity) + identity
    w, h = box_wh(boxes)
    cx, cy = box_center(boxes)
    ncx = cx[..., None] + dx * w[..., None]
    ncy = cy[..., None] + dy * h[..., None]
    nw = w[..., None] * ds
    nh = h[..., None] * ds
    out = torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                       ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)], dim=-1)
    return clip_boxes(out, height, width)


@torch.no_grad()
def perturb_rescore_arrays(model, frames_u8, trk_boxes, trk_mask,
                           opts: PerturbOptions = PerturbOptions()):
    """Max-pooled detector scores over perturbed tubelet boxes.

    frames_u8 (T, H, W, 3) uint8, trk_boxes (K, T, 4), trk_mask (K, T):
    tensors on the model's device. Returns best_scores (K, T, C), the
    per-class maximum over the perturbations (zero on dead frames), and
    best_boxes (K, T, 4), the perturbation with the best foreground score
    (the first maximum) when ``take_best_box``, else the boxes given."""
    T, H, W = frames_u8.shape[:3]
    K = trk_boxes.shape[0]
    P = opts.num_perturb
    pboxes = perturb_boxes(trk_boxes, prng.PRNGKey(opts.seed), opts, H, W)  # (K, T, P, 4)
    rois = pboxes.permute(1, 0, 2, 3).reshape(T, K * P, 4)
    scores, _ = model(preprocess_images(frames_u8, model.config), rois)
    probs = torch.softmax(scores, dim=-1)  # (T, K*P, C)
    C = probs.shape[-1]
    probs = probs.reshape(T, K, P, C).permute(1, 0, 2, 3)  # (K, T, P, C)
    best_scores = probs.amax(2) * trk_mask[..., None]
    if not opts.take_best_box:
        return best_scores, trk_boxes
    best_p = torch.argmax(probs[..., 1:].amax(-1), dim=-1)  # (K, T), first maximum
    idx = best_p[..., None, None].expand(K, T, 1, 4)
    return best_scores, torch.take_along_dim(pboxes, idx, dim=2)[..., 0, :]


def perturb_rescore_track_proto(model, frames_u8: np.ndarray, track_proto: dict, frame_ids,
                                opts: PerturbOptions = PerturbOptions(),
                                batch_frames: int = 32) -> dict:
    """Apply perturbation max-pooling to a track_proto → updated track_proto.

    Each live track box gains ``perturb_scores`` (its best foreground class
    and that class's max-pooled score) and, with ``take_best_box``, moves to
    the best perturbation. The detector runs on the model's device over
    ``batch_frames`` frames a call; each call draws its jitter for its own
    (K, frames, P) shape from ``opts.seed``, as the JAX stage does."""
    trk_boxes, _, trk_mask = track_proto_to_arrays(track_proto, frame_ids)
    if trk_boxes.shape[0] == 0:
        return track_proto
    dev = next(model.parameters()).device
    all_scores, all_boxes = [], []
    T = len(frame_ids)
    for s in range(0, T, batch_frames):
        e = min(s + batch_frames, T)
        sc, bx = perturb_rescore_arrays(
            model,
            torch.from_numpy(np.ascontiguousarray(frames_u8[s:e])).to(dev),
            torch.from_numpy(np.ascontiguousarray(trk_boxes[:, s:e])).to(dev),
            torch.from_numpy(np.ascontiguousarray(trk_mask[:, s:e])).to(dev),
            opts,
        )
        all_scores.append(sc.cpu().numpy())
        all_boxes.append(bx.cpu().numpy())
    scores = np.concatenate(all_scores, axis=1)
    boxes = np.concatenate(all_boxes, axis=1)

    fmap = {int(f): i for i, f in enumerate(frame_ids)}
    out_tracks = []
    for k, track in enumerate(track_proto["tracks"]):
        track_boxes = track["boxes"] if isinstance(track, dict) else track
        new_track = []
        for box in track_boxes:
            t = fmap.get(int(box["frame"]))
            e = dict(box)
            if t is not None and trk_mask[k, t]:
                if opts.take_best_box:
                    e["bbox"] = [float(v) for v in boxes[k, t]]
                cls_scores = scores[k, t]
                best_c = int(np.argmax(cls_scores[1:])) + 1
                e["perturb_scores"] = [{"class_index": best_c,
                                        "score": float(cls_scores[best_c])}]
            new_track.append(e)
        out_tracks.append(new_track)
    return {**{k: v for k, v in track_proto.items() if k != "tracks"}, "tracks": out_tracks}
