"""Meshes and sharding over ``torch.distributed`` — the port's copy of
``vdetlib_tpu/dist/sharding.py``.

- ``data`` mesh dim: snippets or frame batches split across ranks (data
  parallelism, the dominant axis: the networks fit on one card).
- ``model`` mesh dim: kept from the JAX package's mesh; size 1 by default.
- collectives: the gradient sum of the sharded train step
  (``nn/train.py::train_step(mesh=)``), the metric sum of :func:`psum_metrics`
  and the gather of :func:`pipeline.fused.make_sharded_pipeline`.
- the JSON protos on disk stay the transport between stages, now a shard
  each (:func:`shard_videos`).

A mesh needs a process group: :func:`vdetlib_tpu_torch.dist.multihost.init_multihost`
(or ``torch.distributed.init_process_group``) comes first. Its backend is
NCCL for CUDA tensors and gloo on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "psum_metrics", "replicate", "shard_batch", "shard_videos"]


def _device_type() -> str:
    """The process group's device: ``cuda`` under NCCL, else ``cpu``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """A ``("data", "model")`` ``DeviceMesh`` over the first ``n_devices``
    ranks (all of them by default), on the process group's device. Each of
    its groups runs one collective here, so that a first sharded call does
    not pay for connecting it."""
    from torch.distributed.device_mesh import DeviceMesh

    n = n_devices if n_devices is not None else dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    ranks = torch.arange(n).reshape(n // model_parallel, model_parallel)
    mesh = DeviceMesh(_device_type(), ranks, mesh_dim_names=("data", "model"))
    for dim in mesh.mesh_dim_names:  # NCCL connects a group at its first collective
        dist.all_reduce(torch.zeros(1, device=_device_type()), group=mesh.get_group(dim))
    return mesh


def data_rank_size(mesh) -> tuple[int, int]:
    """This rank's index along the mesh's ``data`` dim, and that dim's size."""
    return mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a named tuple
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree):
    """This rank's contiguous block of every leading axis along ``data``
    (``P("data")``'s layout): with D data ranks, rank r keeps rows
    ``[r·B/D, (r+1)·B/D)``. Tensors and numpy arrays; B must divide by D."""
    r, d = data_rank_size(mesh)

    def take(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        b = x.shape[0]
        if b % d:
            raise ValueError(f"leading axis {b} not divisible by the data size {d}")
        n = b // d
        return x[r * n:(r + 1) * n]

    return _map(take, tree)


def replicate(mesh, tree):
    """Rank 0's values on every rank of the mesh: tensors (in place) and the
    parameters and buffers of modules, broadcast along ``model`` then
    ``data``; returns ``tree``."""

    def bcast(t):
        for dim in ("model", "data"):
            group = mesh.get_group(dim)
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)

    def put(x):
        if isinstance(x, torch.nn.Module):
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    bcast(t.data)
        elif isinstance(x, torch.Tensor):
            bcast(x)
        return x

    return _map(put, tree)


def psum_metrics(tree, axis_name: str = "data", mesh=None):
    """Sum a tree of metrics (tensors or numbers) across ``axis_name`` of
    ``mesh`` (all ranks without a mesh); returns tensors."""
    group = mesh.get_group(axis_name) if mesh is not None else None
    device = _device_type()

    def total(x):
        t = torch.as_tensor(x).to(device).clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return _map(total, tree)


def shard_videos(video_paths: Sequence[str], shard_index: int, num_shards: int):
    """Deterministic round-robin split of a video list across pipeline shards
    (process-level data parallelism; outputs stay resume-safe per video)."""
    return [p for i, p in enumerate(video_paths) if i % num_shards == shard_index]
