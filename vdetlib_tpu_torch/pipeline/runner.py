"""The staged engine — counterpart of ``vdetlib_tpu/pipeline/runner.py``.

``PipelineConfig`` (the stage options of detect → MGP → track → rescore →
seq-NMS), ``Models`` and ``dump_config``, which both engines read and
write, and the staged runner: ``run_video`` chains the stages of
``video/`` for one video, writing each stage's proto under
``<workdir>/NAME/`` atomically and skipping a stage whose output exists
(resume-by-existence), and ``run_videos`` runs a sweep of videos, one at a
time or ``workers`` at once. In the port ``Models`` holds the detector and
tracker modules alone: a torch module carries its weights, so there are no
``*_params`` fields.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load
from vdetlib_tpu_torch.utils.log import StageMetrics, get_logger
from vdetlib_tpu_torch.video.detect import DetectOptions, det_vid
from vdetlib_tpu_torch.video.link import LinkOptions, seq_nms_video
from vdetlib_tpu_torch.video.mgp import MGPOptions, mgp
from vdetlib_tpu_torch.video.perturb import perturb_rescore_track_proto
from vdetlib_tpu_torch.video.rescore import RescoreOptions, tubelet_rescore
from vdetlib_tpu_torch.video.track import TrackOptions, track_from_det

__all__ = ["Models", "PipelineConfig", "dump_config", "failed_paths", "load_frames_device",
           "run_video", "run_videos"]

log = get_logger("pipeline")

STAGE_FILES = ("detect", "mgp", "track", "perturbed", "score", "rescored", "final", "tubelets")


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


def load_frames_device(vid_proto: dict, image_hw) -> np.ndarray:
    """Decode a video's frames at ``image_hw`` once: (T, H, W, 3) uint8.

    The JAX function of this name also uploads the frames, once, because its
    TPU's host link was slow and ``mgp``, ``track_from_det`` and the
    perturbation all read them. The port keeps the name so a reader finds
    it, but returns the host array: the port's stages take numpy and each
    uploads what it uses, and on a card the 22 MB of a 96-frame 240×320
    video cross PCIe in milliseconds."""
    loader = FrameLoader(vid_proto, target_hw=image_hw)
    try:
        return np.stack([img for _, img, _ in loader.iter_frames()])
    finally:
        loader.close()


def run_video(workdir: str, vid_proto: dict, box_proto: Optional[dict], models: Models,
              cfg: PipelineConfig, det_proto: Optional[dict] = None, frames_dev=None,
              frames: Optional[np.ndarray] = None, device="cuda") -> dict:
    """Run the staged pipeline for one video; returns output paths per stage.

    The JAX function's stage order, file names, per-stage resume and
    ``result`` rules: ``det_proto`` may be supplied to skip the detect stage;
    ``paths["result"]`` is the last det_proto a stage produced (with a
    supplied det_proto and no such stage, the det_proto itself, written to
    ``detect.json``). The frames that ``mgp``, ``track_from_det`` and the
    perturbation share are decoded at ``cfg.detect.image_hw`` at most once,
    and only when one of them runs; ``frames_dev`` may carry them already
    decoded (``load_frames_device``, the cross-video prefetch of
    ``run_videos``).

    Two differences from JAX. ``device`` (the card unless the caller asks
    for the CPU) is where ``mgp``, ``tubelet_rescore`` and ``seq_nms_video``
    run; ``det_vid``, ``track_from_det`` and the perturbation run on their
    model's device. ``frames`` (T, H, W, 3) uint8 at ``cfg.detect.image_hw``,
    with the proposals in those pixels, replaces the frame files for every
    stage, ``det_vid`` included (``frames_u8=``, as the fused sweep's
    in-memory entries do; the card's machine has no ``cv2``); it cannot be
    combined with ``cfg.detect.device_resize``, which reads native frames."""
    if frames is not None and cfg.detect.device_resize:
        raise ValueError("in-memory frames are at detect.image_hw; detect.device_resize reads "
                         "native frames: pass one or the other")
    vdir = os.path.join(workdir, vid_proto["video"])
    os.makedirs(vdir, exist_ok=True)
    paths = {s: os.path.join(vdir, f"{s}.json") for s in STAGE_FILES}
    if frames is not None:
        frames_dev = frames

    def shared_frames():
        nonlocal frames_dev
        if frames_dev is None:
            frames_dev = load_frames_device(vid_proto, cfg.detect.image_hw)
        return frames_dev

    result_path = None  # the last det_proto a stage produced
    if "detect" in cfg.stages and det_proto is None:
        if proto_exists(paths["detect"]):
            det_proto = proto_load(paths["detect"])
        else:
            det_proto = det_vid(models.detector, vid_proto, box_proto, cfg.detect,
                                frames_u8=frames)
            proto_dump(det_proto, paths["detect"])
        result_path = paths["detect"]
    cur_det = det_proto

    if "mgp" in cfg.stages:
        if proto_exists(paths["mgp"]):
            cur_det = proto_load(paths["mgp"])
        else:
            cur_det = mgp(vid_proto, cur_det, opts=cfg.mgp, frames_u8=shared_frames(),
                          device=device)
            proto_dump(cur_det, paths["mgp"])
        result_path = paths["mgp"]

    track_proto = None
    if "track" in cfg.stages:
        if proto_exists(paths["track"]):
            track_proto = proto_load(paths["track"])
        else:
            track_proto = track_from_det(models.tracker, vid_proto, cur_det, cfg.tracker_cfg,
                                         cfg.track, frames_u8=shared_frames())
            proto_dump(track_proto, paths["track"])

    if "perturb" in cfg.stages and track_proto is not None and cfg.perturb is not None:
        if proto_exists(paths["perturbed"]):
            track_proto = proto_load(paths["perturbed"])
        else:
            frame_ids = [f["frame"] for f in vid_proto["frames"]]
            track_proto = perturb_rescore_track_proto(models.detector, shared_frames(),
                                                      track_proto, frame_ids, cfg.perturb)
            proto_dump(track_proto, paths["perturbed"])

    if "rescore" in cfg.stages and track_proto is not None:
        if proto_exists(paths["rescored"]):
            cur_det = proto_load(paths["rescored"])
        else:
            score_proto, cur_det = tubelet_rescore(vid_proto, cur_det, track_proto, cfg.rescore,
                                                   device=device)
            proto_dump(score_proto, paths["score"])
            proto_dump(cur_det, paths["rescored"])
        result_path = paths["rescored"]

    if "seq_nms" in cfg.stages:
        if proto_exists(paths["final"]):
            cur_det = proto_load(paths["final"])
        else:
            cur_det, tubelets = seq_nms_video(vid_proto, cur_det, cfg.link, device=device)
            proto_dump(tubelets, paths["tubelets"])
            proto_dump(cur_det, paths["final"])
        result_path = paths["final"]

    if result_path is None:
        # a supplied det_proto and no stage that makes one: persist the input
        # so that downstream readers (--eval) have a file
        result_path = paths["detect"]
        if cur_det is not None and not proto_exists(result_path):
            proto_dump(cur_det, result_path)
    paths["result"] = result_path
    return paths


def failed_paths(workdir: str, vid_proto: dict, err: BaseException) -> dict:
    """Paths-shaped marker for a video that failed under keep_going: the
    "result" path is where final.json WOULD be (callers must check existence
    before loading), plus an "error" field for reporting."""
    return {
        "video": vid_proto["video"],
        "result": os.path.join(workdir, vid_proto["video"], "final.json"),
        "error": f"{type(err).__name__}: {err}",
    }


def run_videos(workdir: str, video_inputs, models: Models, cfg: PipelineConfig,
               workers: int = 1, keep_going: bool = False, device="cuda") -> list[dict]:
    """Run the staged pipeline over ``video_inputs``; returns one dict of
    output paths per entry, in input order (``"error"`` set where a video
    failed under ``keep_going``).

    Entries are ``(vid_proto, box_proto)`` or ``(vid_proto, box_proto,
    frames)``, frames in memory as for :func:`run_video`. With ``workers``
    > 1, that many ``run_video`` calls run at once on a thread pool, meant
    to overlap one video's host work (proto loops, JSON, numpy glue) with
    another's device work; each video's chain and files are unchanged.
    The threads share the device's default stream and the GIL: on an H100,
    2 workers ran at 0.64–0.66× of 1 (PERF.md). With ``workers`` 1 and
    ``VDETLIB_TPU_STAGED_PREFETCH=1`` (off by default, as in JAX), one
    thread decodes the next video's frames while the current video runs.
    Options that the port cannot run yet raise before the first video;
    ``keep_going`` does not swallow them.

    Metrics (``StageMetrics("pipeline")``): ``frames``, ``videos`` and
    ``workers``."""
    metrics = StageMetrics("pipeline")
    dump_config(workdir, cfg)
    entries = [(v, b, fr[0] if fr else None) for v, b, *fr in video_inputs]
    n_frames = sum(len(v["frames"]) for v, _, _ in entries)

    def one(vid_proto, box_proto, frames, prefetched=None):
        log.info("pipeline: video %s (%d frames)", vid_proto["video"], len(vid_proto["frames"]))
        try:
            # a failed prefetch decode fails this video, as in JAX
            frames_dev = prefetched.result() if prefetched is not None else None
            return run_video(workdir, vid_proto, box_proto, models, cfg,
                             frames_dev=frames_dev, frames=frames, device=device)
        except Exception as e:
            if not keep_going:
                raise
            log.warning("pipeline: %s FAILED (%s: %s) — continuing (--keep_going)",
                        vid_proto["video"], type(e).__name__, e)
            return failed_paths(workdir, vid_proto, e)

    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            out = list(ex.map(lambda e: one(*e), entries))
    else:
        prefetch = any(s in cfg.stages for s in ("mgp", "track", "perturb")) and \
            os.environ.get("VDETLIB_TPU_STAGED_PREFETCH", "0") == "1"
        out = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            def submit(i):
                if not prefetch or i >= len(entries) or entries[i][2] is not None:
                    return None
                return ex.submit(load_frames_device, entries[i][0], cfg.detect.image_hw)

            fut = submit(0)
            for i, entry in enumerate(entries):
                cur, fut = fut, submit(i + 1)
                out.append(one(*entry, prefetched=cur))
    metrics.set("frames", n_frames)
    metrics.set("videos", len(entries))
    metrics.set("workers", workers)
    metrics.finish()
    return out
