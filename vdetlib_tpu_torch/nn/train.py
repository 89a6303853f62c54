"""Detector training — counterpart of ``vdetlib_tpu/nn/train.py``.

Fast R-CNN losses (softmax cross-entropy over classes + smooth-L1 on the
encoded deltas of foreground ROIs), target assignment, the optimizer and
one training step, on the device of the model. The host-side batch functions
(:func:`augment_photometric`, :func:`make_training_batch`) are numpy copies
of the JAX package's: one ``np.random.Generator`` seed draws the same
images, ROIs and labels in both.

The optimizer is ``torch.optim.AdamW`` with the JAX package's optax chain
around it (:class:`ClippedAdamW`): a global-norm clip that scales only when
the norm reaches the limit, as ``optax.clip_by_global_norm`` does (torch's
``clip_grad_norm_`` divides by ``norm + 1e-6`` whenever it clips), and the
learning rate of update ``k`` read from the schedule at ``k``.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vdetlib_tpu_torch.geometry.boxes import encode_deltas, pairwise_iou
from vdetlib_tpu_torch.nn.detector import preprocess_images

__all__ = [
    "ClippedAdamW", "TrainState", "allreduce_grads", "assign_targets", "augment_photometric",
    "detector_loss", "flat_grads", "init_train_state", "loss_and_terms", "lr_at",
    "make_optimizer", "make_training_batch", "smooth_l1", "train_step",
]


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its moments) and the number
    of steps taken — JAX's ``TrainState(params, opt_state, step)``."""

    model: torch.nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def assign_targets(rois, roi_mask, gt_boxes, gt_classes, gt_mask, fg_thresh: float = 0.5):
    """Per-ROI training targets, batched over leading axes.

    Args:
      rois: (..., R, 4); roi_mask: (..., R) bool.
      gt_boxes: (..., G, 4) padded; gt_classes: (..., G) int; gt_mask: (..., G) bool.
    Returns:
      labels (..., R) int32 — the matched gt's class where IoU >= fg_thresh
      else 0 (background), -1 for padded ROI slots (ignored in the loss);
      bbox_targets (..., R, 4) encoded deltas to the matched gt (zeros for bg).
      The matched gt is the first of the largest IoU, as ``jnp.argmax``.
    """
    iou = pairwise_iou(rois, gt_boxes)  # (..., R, G)
    iou = torch.where(gt_mask[..., None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = torch.max(iou, dim=-1)  # first maximum
    matched_boxes = torch.gather(gt_boxes, -2, best_gt[..., None].expand(best_gt.shape + (4,)))
    matched_classes = torch.gather(gt_classes, -1, best_gt)
    fg = best_iou >= fg_thresh
    labels = torch.where(fg, matched_classes, torch.zeros_like(matched_classes))
    labels = torch.where(roi_mask, labels, torch.full_like(labels, -1))
    bbox_targets = encode_deltas(rois, matched_boxes)
    bbox_targets = torch.where(fg[..., None], bbox_targets, torch.zeros_like(bbox_targets))
    return labels.to(torch.int32), bbox_targets


def smooth_l1(x, beta: float = 1.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _count(mask, group):
    """The number of True entries, summed over ``group``'s ranks when given."""
    n = mask.sum()
    if group is not None:
        dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    return torch.clamp(n, min=1)


def detector_loss(scores, deltas, labels, bbox_targets, bbox_weight: float = 1.0, group=None):
    """Fast R-CNN loss over a padded ROI batch.

    scores: (..., R, K); deltas: (..., R, K, 4); labels: (..., R) with -1 =
    ignore; bbox_targets: (..., R, 4). Returns (loss, {"cls_loss",
    "reg_loss", "n_fg"}). With a process ``group`` the batch is this rank's
    shard: the normalisers (valid and foreground ROIs) are summed over the
    group first, so the ranks' losses sum to the loss of the whole batch.
    """
    labels = labels.long()
    valid = labels >= 0
    labels_c = torch.clamp(labels, min=0)
    logp = F.log_softmax(scores, dim=-1)
    cls_ll = torch.gather(logp, -1, labels_c[..., None])[..., 0]
    n_valid = _count(valid, group)
    cls_loss = -torch.sum(torch.where(valid, cls_ll, torch.zeros_like(cls_ll))) / n_valid

    fg = labels > 0
    idx = labels_c[..., None, None].expand(labels_c.shape + (1, 4))
    picked = torch.gather(deltas, -2, idx)[..., 0, :]  # (..., R, 4)
    reg = torch.sum(smooth_l1(picked - bbox_targets), dim=-1)
    n_fg = _count(fg, group)
    reg_loss = torch.sum(torch.where(fg, reg, torch.zeros_like(reg))) / n_fg
    return cls_loss + bbox_weight * reg_loss, {
        "cls_loss": cls_loss, "reg_loss": reg_loss, "n_fg": n_fg,
    }


def lr_at(count: int, lr: float, schedule: str = "const", total_steps: int = 0) -> float:
    """The learning rate of update ``count`` (0 first).

    ``"cosine"``: ``optax.warmup_cosine_decay_schedule`` from lr/10 to lr
    over ``max(1, total_steps // 20)`` steps, then a cosine to lr/100 at
    ``total_steps`` (the warmup counts in ``total_steps``)."""
    if schedule == "const":
        return lr
    if schedule != "cosine":
        raise ValueError(f"unknown lr schedule: {schedule}")
    warmup = max(1, total_steps // 20)
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine schedule needs total_steps > {warmup}, got {total_steps}")
    init, end = lr / 10, lr / 100
    if count < warmup:
        frac = 1 - count / warmup
        return (init - lr) * frac + lr
    t = min(count - warmup, decay)
    alpha = end / lr
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, weight_decay))``.

    Each step scales every gradient by ``max_norm / norm`` when their global
    norm reaches ``max_norm``, sets the learning rate to the schedule's value
    at the number of updates already made (``lr_at``), then takes torch's
    AdamW step (decoupled decay scaled by the scheduled rate, as optax's).
    The schedule's settings live in the parameter group, so they travel in
    ``state_dict()``."""

    def __init__(self, params, lr: float, weight_decay: float, max_norm: float,
                 schedule: str = "const", total_steps: int = 0):
        lr_at(0, lr, schedule, total_steps)  # refuses an unknown or too short schedule
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        for group in self.param_groups:
            group.update(peak_lr=lr, max_norm=max_norm, schedule=schedule,
                         total_steps=total_steps)

    def updates_made(self) -> int:
        p = self.param_groups[0]["params"][0]
        st = self.state.get(p)
        return int(st["step"]) if st else 0

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None, "ClippedAdamW takes no closure"
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        max_norm = self.param_groups[0]["max_norm"]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = norm >= max_norm
        for g in grads:
            g.copy_(torch.where(clip, (g / norm) * max_norm, g))
        count = self.updates_made()
        for group in self.param_groups:
            group["lr"] = lr_at(count, group["peak_lr"], group["schedule"], group["total_steps"])
        super().step()


def make_optimizer(params, lr: float = 1e-3, weight_decay: float = 1e-4, schedule: str = "const",
                   total_steps: int = 0, max_norm: float = 10.0) -> ClippedAdamW:
    """AdamW + global-norm clip over ``params``; ``schedule="cosine"`` decays
    the lr to lr/100 over ``total_steps`` after a 5% linear warmup."""
    return ClippedAdamW(params, lr, weight_decay, max_norm, schedule, total_steps)


def init_train_state(model: torch.nn.Module, opt: torch.optim.Optimizer) -> TrainState:
    return TrainState(model, opt, 0)


def loss_and_terms(model, batch, group=None):
    """The detector's loss on one batch (on the model's device) and its terms;
    ``group``: see :func:`detector_loss`."""
    images = preprocess_images(batch["images_u8"], model.config)
    scores, deltas = model(images, batch["rois"])
    return detector_loss(scores, deltas, batch["labels"], batch["bbox_targets"], group=group)


_FLAT_GRADS = weakref.WeakKeyDictionary()  # model -> (buffer, its gradient views)


def flat_grads(model) -> torch.Tensor:
    """One buffer that holds every gradient of ``model``: each parameter that
    requires a gradient gets a ``.grad`` that is a view into it (zeros where
    it had none). Made again, with the gradients' values, whenever a
    gradient is no longer its view (as after ``zero_grad(set_to_none=True)``).
    Backward accumulates into the views in place, so one all-reduce of the
    buffer sums every gradient, with no flatten and no copy-back."""
    params = [p for p in model.parameters() if p.requires_grad]
    held = _FLAT_GRADS.get(model)
    if held is None or len(held[1]) != len(params) or any(
            p.grad is not v for p, v in zip(params, held[1])):
        flat = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype,
                           device=params[0].device)
        views = [part.view_as(p) for p, part in zip(params, flat.split(
            [p.numel() for p in params]))]
        for p, v in zip(params, views):
            if p.grad is not None:
                v.copy_(p.grad)
            p.grad = v
        held = _FLAT_GRADS[model] = (flat, views)
    return held[0]


def allreduce_grads(model, group) -> None:
    """Sum every parameter's gradient over ``group`` in place: one all-reduce
    of :func:`flat_grads`."""
    dist.all_reduce(flat_grads(model), op=dist.ReduceOp.SUM, group=group)


def train_step(model, opt, batch, mesh=None) -> dict:
    """One optimizer step on the model's device.

    batch: images_u8 (B, H, W, 3), rois (B, R, 4), labels (B, R),
    bbox_targets (B, R, 4) (any device). Returns the loss terms as tensors
    ("loss", "cls_loss", "reg_loss", "n_fg"), detached.

    With a ``mesh`` (``dist/sharding.py``) the step is data parallel, as
    JAX's step on a sharded batch: ``batch`` is this rank's shard
    (``shard_batch``), the loss divides by the counts of the whole batch,
    the gradients are summed over the ``data`` ranks before the optimizer
    clips and steps, so the parameters stay equal on every rank, and the
    returned terms are the whole batch's. The gradients are then views of
    one buffer (:func:`flat_grads`), zeroed before backward and summed in
    one call after it."""
    dev = next(model.parameters()).device
    b = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    group = None if mesh is None else mesh.get_group("data")
    if group is None:
        opt.zero_grad(set_to_none=True)
    else:
        flat_grads(model).zero_()
    loss, aux = loss_and_terms(model, b, group=group)
    loss.backward()
    if group is not None:
        allreduce_grads(model, group)
    opt.step()
    terms = dict(aux, loss=loss)
    if group is not None:  # each rank's terms are its share of the batch's
        parts = torch.stack([terms[k].detach() for k in ("loss", "cls_loss", "reg_loss")])
        dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=group)
        terms.update(zip(("loss", "cls_loss", "reg_loss"), parts))
    return {k: v.detach() for k, v in terms.items()}


def augment_photometric(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-image brightness/contrast/channel-gain jitter + sensor noise.

    uint8 (B, H, W, 3) → uint8."""
    B = images.shape[0]
    out = images.astype(np.float32)
    gain = rng.uniform(0.7, 1.3, size=(B, 1, 1, 1)).astype(np.float32)
    bias = rng.uniform(-25, 25, size=(B, 1, 1, 1)).astype(np.float32)
    ch_gain = rng.uniform(0.85, 1.15, size=(B, 1, 1, 3)).astype(np.float32)
    out = out * gain * ch_gain + bias
    out += rng.normal(0, 4.0, size=out.shape).astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def make_training_batch(sv, rng: np.random.Generator, opts, num_classes: int) -> dict:
    """One training batch from a SynthVideo (host side).

    Samples jittered-GT + random ROIs per frame and assigns targets. With
    ``opts.augment`` (default off), applies photometric jitter + horizontal
    flips (boxes flipped consistently). Returns CPU tensors: images_u8,
    rois, labels, bbox_targets."""
    T = sv.frames.shape[0]
    B, R = opts.batch_size, opts.max_rois
    idx = rng.choice(T, size=B, replace=T < B)
    images = sv.frames[idx]
    K_gt = sv.gt_boxes.shape[0]
    rois = np.zeros((B, R, 4), np.float32)
    roi_mask = np.zeros((B, R), bool)
    gt_b = np.zeros((B, K_gt, 4), np.float32)
    gt_c = np.zeros((B, K_gt), np.int32)
    gt_m = np.ones((B, K_gt), bool)
    H, W = sv.frames.shape[1:3]
    for bi, t in enumerate(idx):
        gt_b[bi] = sv.gt_boxes[:, t]
        gt_c[bi] = sv.gt_classes
        # hard tier: out-of-view or mostly-occluded boxes stay ground truth
        # for the eval, but are no training targets
        gt_m[bi] = sv.gt_visible[:, t] & (sv.gt_occluded[:, t] < 0.5)
        n = 0
        # jittered gt (fg-rich) then random negatives
        while n < R:
            if n < R // 2:
                k = rng.integers(0, K_gt)
                jit = rng.normal(0, 6, size=4)
                bb = sv.gt_boxes[k, t] + jit
            else:
                x1 = rng.uniform(0, W - 8)
                y1 = rng.uniform(0, H - 8)
                bb = [x1, y1, x1 + rng.uniform(8, 120), y1 + rng.uniform(8, 120)]
            rois[bi, n] = np.clip(bb, 0, [W - 1, H - 1, W - 1, H - 1])
            roi_mask[bi, n] = True
            n += 1
    if getattr(opts, "augment", False):
        images = augment_photometric(images.copy(), rng)
        flip = rng.uniform(size=B) < 0.5
        if flip.any():
            images[flip] = images[flip, :, ::-1]
            for arr in (rois, gt_b):
                x1 = arr[flip, ..., 0].copy()
                x2 = arr[flip, ..., 2].copy()
                arr[flip, ..., 0] = (W - 1) - x2
                arr[flip, ..., 2] = (W - 1) - x1
    labels, bbox_targets = assign_targets(
        torch.from_numpy(rois), torch.from_numpy(roi_mask), torch.from_numpy(gt_b),
        torch.from_numpy(gt_c), torch.from_numpy(gt_m))
    return {
        "images_u8": torch.from_numpy(np.ascontiguousarray(images)),
        "rois": torch.from_numpy(rois),
        "labels": labels,
        "bbox_targets": bbox_targets,
    }
