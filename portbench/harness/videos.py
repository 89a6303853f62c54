"""Seeded synthetic videos and proposals, made on the device.

The drawing follows the port's synthetic tier (``data/synth.py``): a static
noise background (uint8 20..59 per channel, BGR), and 1..4 textured
rectangles (colour 100..254 plus a 16x16 texture of -40..39, tiled) moving
linearly and bouncing off the frame's edges, drawn in order so that later
objects cover earlier ones. The proposals of a frame are, per object,
``R // (2K)`` ground-truth boxes with Gaussian jitter, then uniform random
boxes up to R, clipped to the frame. Everything is drawn with one
``torch.Generator`` on the device per video; the host receives the finished
uint8 frames and float32 proposals, which is what the program takes.

A traffic mix gives the queue's lengths as a fixed sequence (quantiles of a
log-normal, clipped, in the mix's ``order``), the same for every seed; the
seed draws each video's content, so that every seed asks the same work in
the same order.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch


def _quantile_lengths(mu: float, sigma: float, n: int, lo: int, hi: int) -> list[int]:
    return [int(min(max(round(math.exp(mu + sigma * NormalDist().inv_cdf((i + 0.5) / n))), lo),
                    hi)) for i in range(n)]


def queue_lengths(mix: dict) -> list[int]:
    """The queue's video lengths: ``pool`` quantiles of a log-normal of the
    mix's sigma, rounded and clipped, whose location is chosen so that the
    clipped pool's mean is the mix's mean (the clip moves the spread, not the
    mean), in the mix's ``order``."""
    spec = mix["length"]
    sigma, mean, n = spec["sigma"], spec["mean"], spec["pool"]
    lo, hi = spec["clip"]
    a, b = math.log(lo), math.log(hi)
    for _ in range(60):
        mid = (a + b) / 2
        if sum(_quantile_lengths(mid, sigma, n, lo, hi)) < mean * n:
            a = mid
        else:
            b = mid
    out = _quantile_lengths(b, sigma, n, lo, hi)
    return [out[i] for i in spec["order"]]


def video_seed(seed: int, index: int) -> int:
    """A 63-bit seed for video ``index`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _bounce(x, limit):
    period = 2 * limit
    x = torch.remainder(x, period)
    return torch.where(x > limit, period - x, x)


@torch.no_grad()
def make_video(mix: dict, hw, T: int, seed: int, num_rois: int, device):
    """One video: (frames (T, H, W, 3) uint8 numpy, rois (T, R, 4) float32 numpy)."""
    H, W = hw
    g = torch.Generator(device=device).manual_seed(seed)
    k_lo, k_hi = mix["objects"]
    K = int(torch.randint(k_lo, k_hi + 1, (1,), generator=g, device=device))
    s_lo, s_hi = mix["object_size"]
    sizes = _uniform(g, (K, 2), s_lo, s_hi, device)
    pos0 = torch.stack([_uniform(g, (K,), 0, 1, device) * (W - sizes[:, 0]),
                        _uniform(g, (K,), 0, 1, device) * (H - sizes[:, 1])], 1)
    v = mix["max_speed"]
    vel = _uniform(g, (K, 2), -v, v, device)
    colors = torch.randint(100, 255, (K, 3), generator=g, device=device)
    textures = torch.randint(-40, 40, (K, 16, 16, 3), generator=g, device=device).to(torch.int16)
    frames = torch.randint(20, 60, (H, W, 3), generator=g, device=device).to(torch.int16)
    frames = frames[None].expand(T, H, W, 3).clone()

    t = torch.arange(T, dtype=torch.float32, device=device)
    x = _bounce(pos0[:, None, 0] + vel[:, None, 0] * t, W - sizes[:, None, 0])
    y = _bounce(pos0[:, None, 1] + vel[:, None, 1] * t, H - sizes[:, None, 1])
    gt = torch.stack([x, y, x + sizes[:, None, 0] - 1, y + sizes[:, None, 1] - 1], -1)

    ys = torch.arange(H, device=device)[None, :, None]
    xs = torch.arange(W, device=device)[None, None, :]
    for k in range(K):
        xi1 = torch.round(gt[k, :, 0]).long()[:, None, None]
        yi1 = torch.round(gt[k, :, 1]).long()[:, None, None]
        xi2 = torch.round(gt[k, :, 2]).long()[:, None, None] + 1
        yi2 = torch.round(gt[k, :, 3]).long()[:, None, None] + 1
        inside = (xs >= xi1) & (xs < xi2) & (ys >= yi1) & (ys < yi2)  # (T, H, W)
        rep_y = (yi2 - yi1) // 16 + 1
        rep_x = (xi2 - xi1) // 16 + 1
        ty = ((ys - yi1).clamp(min=0) // rep_y).clamp(max=15)
        tx = ((xs - xi1).clamp(min=0) // rep_x).clamp(max=15)
        tex = textures[k][ty, tx]  # (T, H, W, 3)
        filled = (colors[k].to(torch.int16) + tex).clamp(0, 255)
        frames = torch.where(inside[..., None], filled, frames)
    frames = frames.to(torch.uint8)

    R = num_rois
    per_obj = max(1, R // (2 * K))
    jit = mix["jitter_px"] * torch.randn((T, K, per_obj, 4), generator=g, device=device)
    obj = (gt.transpose(0, 1)[:, :, None, :] + jit).reshape(T, K * per_obj, 4)[:, :R]
    n_rand = R - obj.shape[1]
    rx1 = _uniform(g, (T, n_rand), 0, W - s_lo, device)
    ry1 = _uniform(g, (T, n_rand), 0, H - s_lo, device)
    rw = _uniform(g, (T, n_rand), s_lo, s_hi, device)
    rh = _uniform(g, (T, n_rand), s_lo, s_hi, device)
    rnd = torch.stack([rx1, ry1, rx1 + rw, ry1 + rh], -1)
    rois = torch.cat([obj, rnd], 1)
    lim = torch.tensor([W - 1, H - 1, W - 1, H - 1], dtype=torch.float32, device=device)
    rois = torch.minimum(rois.clamp(min=0.0), lim)
    # a box degenerate after clipping keeps one pixel of extent
    rois[..., 2] = torch.maximum(rois[..., 2], rois[..., 0] + 1)
    rois[..., 3] = torch.maximum(rois[..., 3], rois[..., 1] + 1)
    return frames.cpu().numpy(), rois.float().cpu().numpy()


def vid_proto(name: str, T: int) -> dict:
    """An in-memory vid_proto (frames served from memory; placeholder paths)."""
    return {"video": name, "root_path": "",
            "frames": [{"frame": i + 1, "path": f"{i + 1:06d}.jpg"} for i in range(T)]}


def box_proto(name: str, rois: np.ndarray) -> dict:
    """The proposals as a box_proto, in file order per frame."""
    return {"video": name, "boxes": [{"frame": t + 1, "bbox": [float(v) for v in b]}
                                     for t in range(rois.shape[0]) for b in rois[t]]}
