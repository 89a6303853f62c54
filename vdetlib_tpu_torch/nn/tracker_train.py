"""Tracker training — counterpart of ``vdetlib_tpu/nn/tracker_train.py``.

Self-supervised correlation learning: per (frame t, frame t+δ, box) sample,
the NCC response of the template over the search window is trained with
cross-entropy against a Gaussian at the ground-truth displacement bin
(recipe "pair"); recipe "aware" adds a distractor hinge and an occlusion
suppression term (:func:`tracker_loss_aware`). The JAX functions take one
sample and are vmapped; here each takes the batch on its leading axis. The
host samplers are numpy copies of the JAX package's: one
``np.random.Generator`` seed draws the same batches in both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vdetlib_tpu_torch.nn.heads import roi_align
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, correlate, extract_template, \
    search_window
from vdetlib_tpu_torch.nn.train import make_optimizer
from vdetlib_tpu_torch.video.track import tracker_features

__all__ = [
    "make_tracker_batch", "make_tracker_batch_aware", "make_tracker_optimizer",
    "response_and_target", "tracker_loss", "tracker_loss_aware", "tracker_train_step",
    "train_tracker",
]


def _bin_grid(R: int, device):
    """(ys, xs): the (R, R) row and column index of every response bin."""
    ar = torch.arange(R, dtype=torch.float32, device=device)
    return ar[:, None].expand(R, R), ar[None, :].expand(R, R)


def response_and_target(feats_a, feats_b, box_a, box_b, cfg: TrackerConfig,
                        sigma_bins: float = 0.75):
    """Each pair's response map + Gaussian target at the true displacement.

    feats_a, feats_b (B, h, w, C) tracker features; box_a, box_b (B, 4).
    Returns resp (B, R, R) float32, target (B, R, R) summing to 1, in_range
    (B,) bool: the true displacement lies inside the response map. The
    search window is pooled by ``roi_align`` at float32 (stride 4)."""
    template = extract_template(feats_a, box_a, cfg)  # (B, P, P, C)
    win = search_window(box_a, cfg.search_factor)  # (B, 4)
    Q = cfg.search_pool
    P = cfg.template_pool
    R = Q - P + 1
    sfeat = roi_align(feats_b, win[:, None], stride=4, pool=Q)[:, 0]
    resp = correlate(template, sfeat)  # (B, R, R)

    # ground-truth displacement in bins (window-centered)
    cxa = 0.5 * (box_a[:, 0] + box_a[:, 2])
    cya = 0.5 * (box_a[:, 1] + box_a[:, 3])
    cxb = 0.5 * (box_b[:, 0] + box_b[:, 2])
    cyb = 0.5 * (box_b[:, 1] + box_b[:, 3])
    wx = (win[:, 2] - win[:, 0]) / Q
    wy = (win[:, 3] - win[:, 1]) / Q
    gx = (cxb - cxa) / wx + (R - 1) / 2.0
    gy = (cyb - cya) / wy + (R - 1) / 2.0
    ys, xs = _bin_grid(R, resp.device)
    target = torch.exp(-((ys - gy[:, None, None]) ** 2 + (xs - gx[:, None, None]) ** 2)
                       / (2 * sigma_bins**2))
    target = target / torch.clamp(target.sum((-2, -1), keepdim=True), min=1e-6)
    in_range = (gx >= 0) & (gx <= R - 1) & (gy >= 0) & (gy <= R - 1)
    return resp, target, in_range


def _pair_features(model, batch):
    return tracker_features(model, batch["frames_a"]), tracker_features(model, batch["frames_b"])


def _cross_entropy(resp, target, logit_scale: float):
    B = resp.shape[0]
    logp = F.log_softmax((resp * logit_scale).reshape(B, -1), dim=-1)
    return -torch.sum(target.reshape(B, -1) * logp, dim=-1)


def _mean(v, m):
    return torch.sum(v) / torch.clamp(torch.sum(m), min=1)


def tracker_loss(model, cfg: TrackerConfig, batch, logit_scale: float = 10.0):
    """batch: frames_a/b (B, H, W, 3) u8, boxes_a/b (B, 4), on the model's device."""
    fa, fb = _pair_features(model, batch)
    resp, target, in_range = response_and_target(fa, fb, batch["boxes_a"], batch["boxes_b"], cfg)
    ce = _cross_entropy(resp, target, logit_scale)
    ces = torch.where(in_range, ce, torch.zeros_like(ce))
    n = torch.clamp(torch.sum(in_range), min=1)
    return torch.sum(ces) / n, {"n_valid": n}


def tracker_loss_aware(model, cfg: TrackerConfig, batch, logit_scale: float = 10.0,
                       margin: float = 0.2, w_hinge: float = 1.0, w_sup: float = 0.5,
                       sup_level: float = 0.25):
    """Occlusion/distractor-aware loss: three terms over the NCC response map.

    - **CE** at the GT displacement (match samples only) — localization;
    - **distractor hinge**: the Gaussian-weighted response at the GT must
      exceed the largest response over bins whose implied box centre lies
      inside a negative box (and outside the GT box) by ``margin``;
    - **occlusion suppression**: for a target >70% covered, the largest
      response must stay below ``sup_level``.

    batch adds to the pair fields: neg_boxes (B, M, 4), neg_valid (B, M),
    suppress (B,) — see :func:`make_tracker_batch_aware`. The maxima are
    ``torch.amax``, which splits the gradient among ties as ``jnp.max``."""
    fa, fb = _pair_features(model, batch)
    box_a, box_b = batch["boxes_a"], batch["boxes_b"]
    neg_boxes, neg_valid, suppress = batch["neg_boxes"], batch["neg_valid"], batch["suppress"]
    Q = cfg.search_pool
    P = cfg.template_pool
    R = Q - P + 1
    resp, target, in_range = response_and_target(fa, fb, box_a, box_b, cfg)
    match = in_range & ~suppress
    zero = torch.zeros((), dtype=resp.dtype, device=resp.device)

    ce = _cross_entropy(resp, target, logit_scale)
    ce = torch.where(match, ce, zero)

    # bin grid → view-space positions (the inverse of response_and_target's mapping)
    win = search_window(box_a, cfg.search_factor)
    wx = ((win[:, 2] - win[:, 0]) / Q)[:, None, None]
    wy = ((win[:, 3] - win[:, 1]) / Q)[:, None, None]
    cxa = (0.5 * (box_a[:, 0] + box_a[:, 2]))[:, None, None]
    cya = (0.5 * (box_a[:, 1] + box_a[:, 3]))[:, None, None]
    ys, xs = _bin_grid(R, resp.device)
    px = cxa + (xs - (R - 1) / 2.0) * wx  # (B, R, R) implied box centres
    py = cya + (ys - (R - 1) / 2.0) * wy

    # distractor hinge
    nb = neg_boxes[:, :, None, None, :]  # (B, M, 1, 1, 4)
    inside = ((px[:, None] >= nb[..., 0]) & (px[:, None] <= nb[..., 2])
              & (py[:, None] >= nb[..., 1]) & (py[:, None] <= nb[..., 3]))  # (B, M, R, R)
    neg_mask = torch.any(inside & neg_valid[:, :, None, None], dim=1)
    # bins inside the GT box itself are no negatives: during a crossing the
    # distractor overlaps the object and the response there is rightly high
    bb = box_b[:, None, None, :]
    in_gt = (px >= bb[..., 0]) & (px <= bb[..., 2]) & (py >= bb[..., 1]) & (py <= bb[..., 3])
    neg_mask = neg_mask & ~in_gt
    has_neg = torch.any(neg_mask.flatten(1), dim=1)
    neg_max = torch.amax(torch.where(neg_mask, resp, torch.full_like(resp, -1.0)), dim=(-2, -1))
    r_gt = torch.sum(target * resp, dim=(-2, -1))  # Gaussian-weighted GT response
    hinge = torch.maximum(margin + neg_max - r_gt, zero)
    hinge = torch.where(match & has_neg, hinge, zero)

    # occlusion suppression
    sup = torch.maximum(torch.amax(resp, dim=(-2, -1)) - sup_level, zero)
    sup = torch.where(suppress, sup, zero)

    m_h = match & has_neg
    loss = _mean(ce, match) + w_hinge * _mean(hinge, m_h) + w_sup * _mean(sup, suppress)
    return loss, {
        "n_valid": torch.sum(match),
        "ce": _mean(ce, match),
        "hinge": _mean(hinge, m_h),
        "sup": _mean(sup, suppress),
    }


def tracker_loss_for(recipe: str):
    if recipe == "aware":
        return tracker_loss_aware
    if recipe != "pair":
        raise ValueError(f"unknown tracker recipe: {recipe}")
    return tracker_loss


def tracker_train_step(model, cfg: TrackerConfig, opt, batch, recipe: str = "pair") -> dict:
    """One optimizer step on the model's device; returns the loss terms, detached."""
    dev = next(model.parameters()).device
    b = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    opt.zero_grad(set_to_none=True)
    loss, aux = tracker_loss_for(recipe)(model, cfg, b)
    loss.backward()
    opt.step()
    return {k: v.detach() for k, v in dict(aux, loss=loss).items()}


def make_tracker_optimizer(model, lr: float = 1e-3):
    """``optax.chain(clip_by_global_norm(5.0), adamw(lr))``: optax's default
    weight decay 1e-4, a constant lr."""
    return make_optimizer(model.parameters(), lr, weight_decay=1e-4, max_norm=5.0)


def _batch(fa, fb, ba, bb, **extra) -> dict:
    out = {
        "frames_a": np.stack(fa), "frames_b": np.stack(fb),
        "boxes_a": np.stack(ba), "boxes_b": np.stack(bb), **extra,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def make_tracker_batch(videos, rng: np.random.Generator, batch_size: int, max_dt: int = 3) -> dict:
    """Sample (frame pair, box pair) tuples from SynthVideos (CPU tensors)."""
    fa, fb, ba, bb = [], [], [], []
    for _ in range(batch_size):
        sv = videos[int(rng.integers(0, len(videos)))]
        K, T = sv.gt_boxes.shape[:2]
        k = int(rng.integers(0, K))
        dt = int(rng.integers(1, max_dt + 1))
        t = int(rng.integers(0, T - dt))
        fa.append(sv.frames[t])
        fb.append(sv.frames[t + dt])
        ba.append(sv.gt_boxes[k, t])
        bb.append(sv.gt_boxes[k, t + dt])
    return _batch(fa, fb, ba, bb)


def make_tracker_batch_aware(
    videos,
    rng: np.random.Generator,
    batch_size: int,
    cfg: TrackerConfig,
    max_dt: int = 4,
    n_neg: int = 8,
    hard_frac: float = 0.6,
    sup_frac: float = 0.15,
) -> dict:
    """Occlusion/distractor-aware pair sampler (CPU tensors).

    - ~``hard_frac`` of match samples are hard: the path t→t+dt crosses an
      occlusion (gt_occluded > 0.2 on it), or a distractor/other object
      lies within the response map's span at the target frame;
    - ~``sup_frac`` are suppression samples: the object is >70% covered at
      the target frame;
    - every sample carries up to ``n_neg`` negative boxes (visible other
      objects + distractors that are on at the target frame);
    - match anchors are mostly clean (gt_occluded <= 0.3)."""
    fa, fb, ba, bb = [], [], [], []
    neg_b = np.zeros((batch_size, n_neg, 4), np.float32)
    neg_v = np.zeros((batch_size, n_neg), bool)
    sup = np.zeros((batch_size,), bool)

    # suppression events are sampled event first (occluded target frame →
    # walk back to a cleaner anchor): rejection sampling almost never finds
    # a clean anchor and a >70%-covered target in one random (t, dt)
    sup_events = []  # (video index, k, b)
    for vi, sv in enumerate(videos):
        ks, bs = np.where((sv.gt_occluded > 0.7) & sv.gt_visible)
        sup_events += [(vi, int(k), int(b)) for k, b in zip(ks, bs) if b > 0]

    def draw(video_pool):
        sv = video_pool[int(rng.integers(0, len(video_pool)))]
        K, T = sv.gt_boxes.shape[:2]
        k = int(rng.integers(0, K))
        dt = int(rng.integers(1, max_dt + 1))
        t = int(rng.integers(0, T - dt))
        return sv, k, t, t + dt

    def anchor_ok(sv, k, t):
        return bool(sv.gt_visible[k, t]) and float(sv.gt_occluded[k, t]) <= 0.3

    def negs_at(sv, k, b):
        """Negative boxes near the anchor at the target frame."""
        out = []
        K = sv.gt_boxes.shape[0]
        for j in range(K):
            if j != k and sv.gt_visible[j, b]:
                out.append(sv.gt_boxes[j, b])
        if sv.distractor_boxes is not None:
            for d in range(sv.distractor_boxes.shape[0]):
                if sv.distractor_on[d, b]:
                    out.append(sv.distractor_boxes[d, b])
        return out

    # the hinge sees only the bins of the response map: implied box centres
    # span ± (R-1)/2 · window/Q around the anchor's centre
    Q = cfg.search_pool
    Rbins = Q - cfg.template_pool + 1

    def near_window(box_a, nb):
        cx = 0.5 * (box_a[0] + box_a[2])
        cy = 0.5 * (box_a[1] + box_a[3])
        hw = (Rbins - 1) / 2.0 * cfg.search_factor * (box_a[2] - box_a[0]) / Q
        hh = (Rbins - 1) / 2.0 * cfg.search_factor * (box_a[3] - box_a[1]) / Q
        return not (
            nb[2] < cx - hw or nb[0] > cx + hw
            or nb[3] < cy - hh or nb[1] > cy + hh
        )

    for i in range(batch_size):
        want_sup = bool(sup_events) and rng.uniform() < sup_frac
        want_hard = rng.uniform() < hard_frac
        want_neg = rng.uniform() < 0.5
        chosen = None
        if want_sup:
            for _ in range(24):
                vi, k, b = sup_events[int(rng.integers(0, len(sup_events)))]
                sv = videos[vi]
                lo = max(0, b - max(max_dt, 6))
                # the least-occluded visible anchor in the window, which must
                # be clearly cleaner than the target
                cand_ts = [t for t in range(lo, b) if sv.gt_visible[k, t]]
                if not cand_ts:
                    continue
                t = min(cand_ts, key=lambda t_: float(sv.gt_occluded[k, t_]))
                occ_t = float(sv.gt_occluded[k, t])
                if occ_t <= 0.5 and occ_t <= float(sv.gt_occluded[k, b]) - 0.2:
                    chosen = (sv, k, t, b, True)
                    break
        for _ in range(0 if chosen else 24):
            sv, k, t, b = draw(videos)
            if not anchor_ok(sv, k, t) or not sv.gt_visible[k, b]:
                continue
            occ_b = float(sv.gt_occluded[k, b])
            if occ_b > 0.7:
                continue  # evidence-free target for a match sample
            if want_hard:
                # half the hard draws demand an in-span negative, half an
                # occlusion crossing (occlusion alone would crowd the hinge out)
                if want_neg:
                    if any(
                        near_window(sv.gt_boxes[k, t], nb)
                        for nb in negs_at(sv, k, b)
                    ):
                        chosen = (sv, k, t, b, False)
                        break
                elif float(sv.gt_occluded[k, t : b + 1].max()) > 0.2:
                    chosen = (sv, k, t, b, False)
                    break
                continue
            chosen = (sv, k, t, b, False)
            break
        if chosen is None:  # fall back to any valid clean pair
            while True:
                sv, k, t, b = draw(videos)
                if anchor_ok(sv, k, t) and sv.gt_visible[k, b] and float(
                    sv.gt_occluded[k, b]
                ) <= 0.7:
                    chosen = (sv, k, t, b, False)
                    break
        sv, k, t, b, is_sup = chosen
        fa.append(sv.frames[t])
        fb.append(sv.frames[b])
        ba.append(sv.gt_boxes[k, t])
        bb.append(sv.gt_boxes[k, b])
        sup[i] = is_sup
        negs = [nb for nb in negs_at(sv, k, b) if near_window(sv.gt_boxes[k, t], nb)]
        for m, nb in enumerate(negs[:n_neg]):
            neg_b[i, m] = nb
            neg_v[i, m] = True

    return _batch(fa, fb, ba, bb, neg_boxes=neg_b, neg_valid=neg_v, suppress=sup)


def train_tracker(model, cfg: TrackerConfig, videos, steps: int = 200, batch_size: int = 8,
                  lr: float = 1e-3, seed: int = 0, log_every: int = 50, recipe: str = "pair"):
    """Train ``model`` in place on its device; returns it."""
    from vdetlib_tpu_torch.utils.log import get_logger

    log = get_logger("train_tracker")
    tracker_loss_for(recipe)  # refuses an unknown recipe before any work
    opt = make_tracker_optimizer(model, lr)
    rng = np.random.default_rng(seed)
    model.train()
    for step in range(steps):
        if recipe == "aware":
            batch = make_tracker_batch_aware(videos, rng, batch_size, cfg)
        else:
            batch = make_tracker_batch(videos, rng, batch_size)
        aux = tracker_train_step(model, cfg, opt, batch, recipe=recipe)
        if step % log_every == 0 or step == steps - 1:
            if recipe == "aware":
                log.info(
                    "step %d loss=%.4f ce=%.4f hinge=%.4f sup=%.4f",
                    step, float(aux["loss"]), float(aux["ce"]),
                    float(aux["hinge"]), float(aux["sup"]),
                )
            else:
                log.info("step %d loss=%.4f", step, float(aux["loss"]))
    return model.eval()
