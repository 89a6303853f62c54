"""Model weight checkpoints — counterpart of ``vdetlib_tpu/pipeline/checkpoint.py``.

A checkpoint is one file written by ``torch.save``:
``{"format": "vdetlib_tpu_torch.params/1", "state_dict": {name: tensor}}``,
with every tensor on the CPU. :func:`load_params` reads it with
``weights_only=True`` (no code runs while it loads) and loads it into a
model strictly: a missing key, an extra key or a wrong shape raises and
names the key.

The JAX package writes Orbax checkpoint directories. The port cannot read
them (it imports neither JAX nor orbax): ``scripts/convert_orbax_checkpoint.py``
converts one into this format on a machine that has both.

``save_train_state`` / ``load_train_state`` are not ported: the port's
train state is whatever its trainer defines, and the port has no trainer
yet (ROADMAP.md, Queue 1: training).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

FORMAT = "vdetlib_tpu_torch.params/1"
CONVERTER = "scripts/convert_orbax_checkpoint.py"

__all__ = ["FORMAT", "load_params", "save_params"]


def save_params(path: str, model_or_state_dict) -> None:
    """Write a module's (or a state_dict's) tensors to ``path``, atomically."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    sd = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"format": FORMAT, "state_dict": sd}, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _check_against(model: torch.nn.Module, sd: dict, path: str) -> None:
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"{path}: checkpoint does not fit the model: missing keys {missing}, "
                         f"unexpected keys {extra}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{path}: key {k!r} has shape {tuple(v.shape)} in the checkpoint "
                             f"and {tuple(want[k].shape)} in the model")


def load_params(path: str, model: Optional[torch.nn.Module] = None):
    """Read a checkpoint written by :func:`save_params`.

    With ``model``, its tensors are loaded into it (``strict=True``, on the
    model's own device) and the model is returned; without, the state_dict
    (CPU tensors) is returned."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint of the JAX package: convert it "
            f"with `python {CONVERTER} {{detector,tracker}} {path} OUT.pt` on a machine "
            f"with JAX and orbax, then load OUT.pt")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    sd = blob["state_dict"]
    if model is None:
        return sd
    _check_against(model, sd, path)
    model.load_state_dict(sd, strict=True)
    return model
