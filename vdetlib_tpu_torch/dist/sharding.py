"""Video-list sharding — the port's copy of ``shard_videos`` from
``vdetlib_tpu/dist/sharding.py``.

Meshes, sharded pipelines and multi-host runs are not ported yet
(ROADMAP.md, Queue 1: the last slice).
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["shard_videos"]


def shard_videos(video_paths: Sequence[str], shard_index: int, num_shards: int):
    """Deterministic round-robin split of a video list across pipeline shards
    (process-level data parallelism; outputs stay resume-safe per video)."""
    return [p for i, p in enumerate(video_paths) if i % num_shards == shard_index]
