"""Multi-process runtime over ``torch.distributed`` — the port's copy of
``vdetlib_tpu/dist/multihost.py``.

The reference's only distributed mode was one pipeline process per video
shard over a shared filesystem. This keeps that structure and makes it a
runtime:

- :func:`init_multihost` starts the process group from torch's standard
  environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
  ``torchrun`` sets them) or from its arguments: NCCL on the card, gloo on
  the CPU;
- :func:`process_video_shard` gives each process its disjoint video subset
  (round-robin by rank); outputs stay resume-safe per video, so a lost
  process's shard can be rerun anywhere;
- :func:`allreduce_metrics` sums a flat dict of metrics across processes,
  the only collective a sweep needs.

Tested with two coordinated gloo processes on the CPU
(``tests/test_torch_multihost.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from vdetlib_tpu_torch.dist.sharding import _device_type, shard_videos
from vdetlib_tpu_torch.utils.log import get_logger

log = get_logger("dist.multihost")

__all__ = ["allreduce_metrics", "init_multihost", "process_video_shard"]


def _env_address() -> Optional[str]:
    if "MASTER_ADDR" not in os.environ:
        return None
    return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: Optional[str] = None) -> bool:
    """Start the process group; a no-op for one process without an address.

    ``coordinator_address`` is ``host:port`` (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` and ``process_id`` default to
    ``WORLD_SIZE`` and ``RANK``. ``device`` "cuda" (the default where a card
    is present) takes NCCL and this process's card (``LOCAL_RANK``, else the
    rank modulo the cards), anything else gloo. Returns True when a group is
    up (also when one already was). Ends with one collective, so that every
    process has met the others before its shard's work begins."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _env_address()
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's address, the number of "
                         "processes and this process's rank (MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log.info("multihost up: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(),
             backend)
    allreduce_metrics({"_init_warmup": 0.0})
    return True


def _rank_and_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_video_shard(video_paths: Sequence[str]) -> list:
    """This process's disjoint video subset (round-robin by rank)."""
    return shard_videos(video_paths, *_rank_and_size())


def allreduce_metrics(metrics: dict) -> dict:
    """Sum a flat dict of scalar metrics across all processes; plain floats.

    Values are Python or numpy scalars (flatten nested metrics first). One
    float64 all-reduce a call, on the card under NCCL; a single process
    returns its own values."""
    if _rank_and_size()[1] == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                     device=_device_type())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return dict(zip(keys, t.tolist()))
