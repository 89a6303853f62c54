"""Flax parameter trees → torch modules, and seeded initialisation.

``detector_state_from_flax`` / ``tracker_state_from_flax`` take the JAX
package's parameter tree as nested dicts of numpy arrays (the caller runs
``jax.tree.map(np.asarray, params)``; this module imports no JAX) and return
a ``state_dict`` for :class:`~vdetlib_tpu_torch.nn.detector.Detector` /
:class:`~vdetlib_tpu_torch.nn.tracker_net.TrackerNet`. Conv kernels go HWIO →
OIHW, dense kernels are transposed. The head's first layer (``Dense_0``, the
JAX ``_PooledDense``) is laid out (p, q, c) × H, which is the order in which
the port flattens its pooled (P, P, C) features, so a transpose suffices.

``adam_state_from_optax`` carries an optax Adam state across: ``mu`` and
``nu`` have the params' tree, so the same mapping applies to them (the
conv transposes move elements and change no value).

``init_detector`` / ``init_tracker`` draw fresh weights the way Flax does
(lecun-normal fan-in, truncated at ±2σ; zero biases; unit GroupNorm scales,
and R-FCN's BN affines set to the identity) from a ``torch.Generator``. They cannot give Flax's numbers: the parity
tests always use converted weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vdetlib_tpu_torch.nn.backbone import GroupNorm
from vdetlib_tpu_torch.nn.presets import build_detector
from vdetlib_tpu_torch.nn.rfcn import Affine
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet

__all__ = [
    "adam_state_from_optax", "detector_state_from_flax", "init_detector", "init_tracker",
    "tracker_state_from_flax",
]


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _conv(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def _dense(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).T))


def _vec(v):
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def _gn(sd, prefix, p):
    sd[f"{prefix}.weight"] = _vec(p["scale"])
    sd[f"{prefix}.bias"] = _vec(p["bias"])


def detector_state_from_flax(params_np) -> dict:
    """Flax ``init_detector`` params (numpy leaves) → ``Detector`` state_dict."""
    p = _params(params_np)
    bb, hd = p["backbone"], p["head"]
    sd = {"backbone.stem.weight": _conv(bb["Conv_0"]["kernel"])}
    _gn(sd, "backbone.stem_gn", bb["GroupNorm_0"])
    i = 0
    while f"ResBlock_{i}" in bb:
        rb = bb[f"ResBlock_{i}"]
        pre = f"backbone.blocks.{i}"
        sd[f"{pre}.conv0.weight"] = _conv(rb["Conv_0"]["kernel"])
        _gn(sd, f"{pre}.gn0", rb["GroupNorm_0"])
        sd[f"{pre}.conv1.weight"] = _conv(rb["Conv_1"]["kernel"])
        _gn(sd, f"{pre}.gn1", rb["GroupNorm_1"])
        if "Conv_2" in rb:  # projection shortcut
            sd[f"{pre}.proj.weight"] = _conv(rb["Conv_2"]["kernel"])
            _gn(sd, f"{pre}.proj_gn", rb["GroupNorm_2"])
        i += 1
    for src, dst in (("Dense_0", "fc0"), ("Dense_1", "fc1"), ("cls", "cls"), ("bbox", "bbox")):
        sd[f"head.{dst}.weight"] = _dense(hd[src]["kernel"])
        sd[f"head.{dst}.bias"] = _vec(hd[src]["bias"])
    return sd


def tracker_state_from_flax(params_np) -> dict:
    """Flax ``init_tracker`` params (numpy leaves) → ``TrackerNet`` state_dict."""
    p = _params(params_np)
    sd = {}
    i = 0
    while f"GroupNorm_{i}" in p:
        sd[f"convs.{i}.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
        _gn(sd, f"gns.{i}", p[f"GroupNorm_{i}"])
        i += 1
    sd["out.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
    sd["out.bias"] = _vec(p[f"Conv_{i}"]["bias"])
    return sd


def adam_state_from_optax(count, mu, nu, state_from_flax, model: nn.Module,
                          opt: torch.optim.Optimizer) -> dict:
    """An optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; numpy leaves)
    → a state_dict for ``opt``, a ``torch.optim.AdamW`` built over
    ``model.parameters()``.

    ``state_from_flax`` is :func:`detector_state_from_flax` or
    :func:`tracker_state_from_flax`; ``count`` is the number of updates
    made, torch's per-parameter ``step``. The parameter groups are
    ``opt``'s own (learning rate, decay, clip and schedule)."""
    m, v = state_from_flax(mu), state_from_flax(nu)
    names = [n for n, _ in model.named_parameters()]
    groups = opt.state_dict()["param_groups"]
    if sorted(names) != sorted(m) or sum(len(g["params"]) for g in groups) != len(names):
        raise ValueError("the optax state does not fit the model and its optimizer")
    step = float(np.asarray(count))
    state = {i: {"step": torch.tensor(step), "exp_avg": m[n], "exp_avg_sq": v[n]}
             for i, n in enumerate(names)}
    return {"state": state, "param_groups": groups}


def _lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax defaults: lecun-normal kernels (truncated ±2σ), zero biases, unit GN
    scales; R-FCN's BN affines unit scales and zero shifts."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation-corrected
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (GroupNorm, Affine)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


def init_detector(cfg, generator: torch.Generator | None = None,
                  device="cuda") -> nn.Module:
    """The detector of ``cfg`` (a ``DetectorConfig`` or an ``RFCNConfig``,
    ``nn/presets.py::build_detector``) with Flax-style random weights drawn
    from ``generator``.

    On the card unless the caller asks for another device; without a card
    the default raises (it never moves to the CPU by itself)."""
    model = build_detector(cfg)
    _lecun_init_(model, generator or torch.Generator().manual_seed(0))
    return model.to(device).eval()


def init_tracker(cfg: TrackerConfig = TrackerConfig(), generator: torch.Generator | None = None,
                 device="cuda") -> TrackerNet:
    """A ``TrackerNet`` with Flax-style random weights drawn from ``generator``
    (on the card unless the caller asks for another device, as
    :func:`init_detector`)."""
    model = TrackerNet(cfg)
    _lecun_init_(model, generator or torch.Generator().manual_seed(0))
    return model.to(device).eval()
