"""Pipeline configuration tree — counterpart of ``vdetlib_tpu/pipeline/runner.py``.

``PipelineConfig`` (the stage options of detect → MGP → track → rescore →
seq-NMS), ``Models`` and ``dump_config``, which the fused sweep
(``pipeline/fused_runner.py``) reads and writes. In the port ``Models``
holds the detector and tracker modules alone: a torch module carries its
weights, so there are no ``*_params`` fields. The staged engine
(``run_video`` / ``run_videos``) is not ported yet (ROADMAP.md, Queue 1:
the staged runner); the stages it chains are in ``video/``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field

from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
from vdetlib_tpu_torch.video.detect import DetectOptions
from vdetlib_tpu_torch.video.link import LinkOptions
from vdetlib_tpu_torch.video.mgp import MGPOptions
from vdetlib_tpu_torch.video.rescore import RescoreOptions
from vdetlib_tpu_torch.video.track import TrackOptions

__all__ = ["Models", "PipelineConfig", "dump_config"]


@dataclass
class PipelineConfig:
    detect: DetectOptions = field(default_factory=DetectOptions)
    mgp: MGPOptions = field(default_factory=MGPOptions)
    track: TrackOptions = field(default_factory=TrackOptions)
    tracker_cfg: TrackerConfig = field(default_factory=TrackerConfig)
    rescore: RescoreOptions = field(default_factory=RescoreOptions)
    link: LinkOptions = field(default_factory=LinkOptions)
    # optional "perturb" stage between track and rescore (PerturbOptions or None)
    perturb: object = None
    stages: tuple = ("detect", "mgp", "track", "rescore", "seq_nms")


@dataclass
class Models:
    """The detector and tracker modules, each on the device it runs on."""

    detector: object = None
    tracker: object = None


def dump_config(workdir: str, cfg: PipelineConfig) -> str:
    """Write the whole stage-config tree to ``workdir/pipeline_config.json``
    (the JAX function's format: dataclasses as objects, tuples as lists,
    anything else as its ``str``)."""

    def enc(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: enc(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if isinstance(obj, (list, tuple)):
            return [enc(v) for v in obj]
        if isinstance(obj, (str, int, float, bool)) or obj is None:
            return obj
        return str(obj)

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "pipeline_config.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(enc(cfg), f, indent=2)
    return path
