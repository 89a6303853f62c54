"""Seeded weights, made on the device, and the two sides' networks.

Every convolution and dense kernel is drawn N(0, 1/fan_in) (LeCun normal,
not truncated), biases are zero and GroupNorm scales one, from one
``torch.Generator`` on the device in one call per network. A configuration's
``weights`` section then shapes the head as a trained detector's would be:
the class logits scaled by ``cls_logit_scale``, so that the configuration's
own thresholds select detections, and the box deltas by ``bbox_scale``.
The same state dicts load into the program's modules and the reference's.
The detector is the configuration's architecture
(``portbench/architectures/<name>.py``); the tracker is every T-CNN
configuration's.
"""

from __future__ import annotations

import torch

from portbench import architectures


def draw_state(module: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``module``'s parameters, drawn on ``device``."""
    named = list(module.named_parameters())
    total = sum(p.numel() for _, p in named)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    state, off = {}, 0
    for name, p in named:
        n = p.numel()
        chunk = flat[off:off + n].view(p.shape)
        off += n
        if name.endswith("bias"):
            value = torch.zeros_like(chunk)
        elif p.dim() == 1:  # GroupNorm scale
            value = torch.ones_like(chunk)
        else:
            value = chunk * (1.0 / (p[0].numel() ** 0.5))
        state[name] = value.contiguous()
    return state


def program_models(config: dict, seed: int, device):
    """The port's detector and tracker for ``config`` with seeded weights →
    (detector, tracker, tracker config, detector state, tracker state)."""
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet

    arch = architectures.of(config)
    det = arch.program(config, device)
    trk_cfg = TrackerConfig()
    check_tracker(trk_cfg, config["tracker"])
    with torch.device(device):
        trk = TrackerNet(trk_cfg).eval()
    det_state = arch.shape_head(draw_state(det, seed, device), config["weights"])
    trk_state = draw_state(trk, seed + 1, device)
    det.load_state_dict(det_state)
    trk.load_state_dict(trk_state)
    for m in (det, trk):
        m.requires_grad_(False)
    return det, trk, trk_cfg, det_state, trk_state


def check_tracker(trk_cfg, arch: dict) -> None:
    """Refuse a tracker config that is not the configuration file's tracker."""
    got = {"features": list(trk_cfg.features), "out_features": trk_cfg.out_features,
           "template_pool": trk_cfg.template_pool, "search_factor": trk_cfg.search_factor,
           "num_scales": trk_cfg.num_scales, "template_eta": trk_cfg.template_eta,
           "dtype": str(trk_cfg.dtype).replace("torch.", "")}
    same("tracker", got, arch)


def same(what: str, got: dict, want: dict) -> None:
    """Refuse a network of the program that is not the configuration's."""
    diff = {k: (got[k], want.get(k)) for k in got if got[k] != want.get(k)}
    if diff:
        raise SystemExit(f"the program's {what} is not the configuration's: {diff}")


def reference_models(config: dict, det_state: dict, trk_state: dict, device, lower: bool = False):
    """The reference's detector and tracker with the same weights; ``lower``
    computes every stage one number format down (the control)."""
    from portbench.reference.nets import TrackerNet
    from portbench.reference.precision import Precisions

    arch = architectures.of(config)
    prec = Precisions.from_config(config["precision"], arch.STAGES, lower=lower)
    with torch.device(device):
        det = arch.reference(config["detector"], prec).eval()
        trk = TrackerNet(config["tracker"], prec).eval()
    det.load_state_dict(det_state)
    trk.load_state_dict(trk_state)
    for m in (det, trk):
        m.requires_grad_(False)
    return det, trk
