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

A train state (:func:`save_train_state`, the trainers' ``TrainState``:
model, optimizer, step) is one ``torch.save`` file too:
``{"format": "vdetlib_tpu_torch.train_state/1", "model": state_dict,
"optimizer": the optimizer's state_dict, "step": int}``, every tensor on
the CPU. :func:`load_train_state` checks the model's keys and shapes as
:func:`load_params` does and the optimizer's parameter count and moments'
shapes, then loads both; a run resumed from it takes the same next step,
bit for bit, as the run that wrote it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

FORMAT = "vdetlib_tpu_torch.params/1"
TRAIN_STATE_FORMAT = "vdetlib_tpu_torch.train_state/1"
CONVERTER = "scripts/convert_orbax_checkpoint.py"

__all__ = ["FORMAT", "TRAIN_STATE_FORMAT", "load_params", "load_train_state", "save_params",
           "save_train_state"]


def _cpu(tree):
    """A state_dict tree with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _write(path: str, blob: dict) -> None:
    """``torch.save`` to a temporary file beside ``path``, then rename."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(blob, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_params(path: str, model_or_state_dict) -> None:
    """Write a module's (or a state_dict's) tensors to ``path``, atomically."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    _write(path, {"format": FORMAT, "state_dict": _cpu(dict(sd))})


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


def _read(path: str, fmt: str) -> dict:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != fmt:
        raise ValueError(f"{path}: not a {fmt} checkpoint")
    return blob


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
    sd = _read(path, FORMAT)["state_dict"]
    if model is None:
        return sd
    _check_against(model, sd, path)
    model.load_state_dict(sd, strict=True)
    return model


def save_train_state(path: str, state) -> None:
    """Persist a train state (model, optimizer moments, step) for resume."""
    _write(path, {"format": TRAIN_STATE_FORMAT, "model": _cpu(state.model.state_dict()),
                  "optimizer": _cpu(state.opt.state_dict()), "step": int(state.step)})


def load_train_state(path: str, template):
    """Load a train state written by :func:`save_train_state` into
    ``template``'s model and optimizer (fresh ones of the same shapes);
    returns the template's type with the saved step."""
    blob = _read(path, TRAIN_STATE_FORMAT)
    model, opt = template.model, template.opt
    _check_against(model, blob["model"], path)
    osd = blob["optimizer"]
    params = [p for g in opt.param_groups for p in g["params"]]
    n_saved = sum(len(g["params"]) for g in osd["param_groups"])
    if n_saved != len(params) or len(osd["param_groups"]) != len(opt.param_groups):
        raise ValueError(f"{path}: the optimizer state holds {n_saved} parameters in "
                         f"{len(osd['param_groups'])} groups, the optimizer {len(params)} in "
                         f"{len(opt.param_groups)}")
    for i, st in osd["state"].items():
        for k, v in st.items():
            if v.dim() and tuple(v.shape) != tuple(params[i].shape):
                raise ValueError(f"{path}: optimizer state {k!r} of parameter {i} has shape "
                                 f"{tuple(v.shape)}, the parameter {tuple(params[i].shape)}")
    model.load_state_dict(blob["model"], strict=True)
    opt.load_state_dict(osd)
    return type(template)(model, opt, int(blob["step"]))
