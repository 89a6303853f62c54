"""Detector architectures, one module a detector: a configuration file's
top-level ``"architecture"`` names ``portbench/architectures/<name>.py``,
found by its file name, so a new detector enters as a new file.

An architecture module defines:

- ``STAGES``: the names of the number-format stages its reference reads from
  :class:`~portbench.reference.precision.Precisions`, besides the stages
  every T-CNN configuration shares (``precision.SHARED``: the flow and the
  tracker's). A configuration's ``precision`` section states exactly both.
- ``program(config, device)``: the port's detector for ``config["model"]``,
  built on ``device`` through the port's own public constructors, in eval
  mode; refused (``SystemExit``) where it differs from the configuration's
  ``detector`` section. The port's engines call it as ``model(images, rois)
  -> (scores (B, R, K) float32, deltas (B, R, K, 4) float32)`` on images
  made by ``(u8 - model.config.pixel_mean) * model.config.pixel_scale``.
- ``shape_head(state, weights)``: the seeded state dict with the class
  logits' kernel scaled by ``weights["cls_logit_scale"]`` and the box deltas'
  by ``weights["bbox_scale"]``, named as this detector names them.
- ``reference(arch, prec)``: the plain-PyTorch detector for the
  configuration's ``detector`` section ``arch`` and its formats ``prec``,
  with the program's parameter names (one state dict loads into both),
  exposing ``.arch``, ``.prec`` and ``forward(images, rois) -> (logits
  (B, R, K) float32, deltas (B, R, K, 4) float32)``; ``arch`` carries
  ``pixel_mean`` and ``pixel_scale``. It imports nothing of the port.
- ``detect_flops(det, h, w, n_rois)``: one frame's detection FLOPs at
  ``h`` x ``w`` with ``n_rois`` proposals, by component, under the port's
  names ``detect/backbone``, ``detect/roi_align`` and ``detect/head``, in
  that order.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys

FOLDER = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"[A-Za-z0-9_]{1,64}")


def load(name: str):
    """The module ``<FOLDER>/<name>.py``, imported once a process."""
    path = os.path.join(FOLDER, f"{name}.py")
    if not NAME.fullmatch(name) or name == "__init__" or not os.path.isfile(path):
        raise SystemExit(f"no detector architecture {name!r}: {path} does not exist")
    key = "portbench_architecture_" + name
    mod = sys.modules.get(key)
    if mod is None or mod.__file__ != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def of(config: dict):
    """The architecture module ``config`` names, with its ``precision``
    section held to the shared stages and the module's ``STAGES``."""
    from portbench.reference.precision import Precisions

    if "architecture" not in config:
        raise SystemExit(f"configuration {config.get('name')!r} names no \"architecture\" "
                         f"(a file of {FOLDER})")
    mod = load(config["architecture"])
    try:
        Precisions.from_config(config["precision"], mod.STAGES)
    except ValueError as e:
        raise SystemExit(f"configuration {config.get('name')!r}: {e}") from None
    return mod
