"""Fused-engine sweep — counterpart of ``vdetlib_tpu/pipeline/fused_runner.py``.

Each video of a sweep runs through the fused pipeline (``pipeline/fused.py``)
and leaves the same wire protos as the staged engine:

  decode + pack proposals + host→device upload (one prefetch thread, which
  loads group g+1 while group g computes)
  → pad to a T bucket (a multiple of the detect batch)
  → fused detect → MGP → track → rescore → seq-NMS
  → ``<workdir>/NAME/final.json`` (det_proto) and ``tubelets.json``
    (track_proto), written atomically.

A video whose ``final.json`` exists is skipped (resume at video granularity:
the stage boundaries live inside the pipeline, so per-stage resume does not
apply). With ``keep_going`` a video that fails to load or run is logged,
marked with ``"error"`` in its result, and the sweep goes on.

Two adaptations of the JAX runner:

- **Grouping.** JAX vmaps one program over a group of same-bucket videos.
  The port's ``FusedPipeline`` and its kernels take one video, so
  :meth:`FusedEngine.run_group` runs the group's videos one after another
  through the same pipeline: ``group_size`` > 1 gives results equal to
  ``group_size`` 1, byte for byte (the JAX runner allows bf16-level
  divergence for grouped runs; the port has none). The group still sets how
  many videos the prefetch thread loads ahead.
- **In-memory frames.** An entry of ``video_inputs`` may carry a third
  element, the video's frames ``(T, H, W, 3)`` uint8 already at
  ``image_hw``, served through ``FrameLoader(frames=...)`` instead of
  decoding the JPEGs (which needs ``cv2``; the GPU machine has none). This
  follows the JAX package's ``frames_u8=`` convention. Without it, frames are
  decoded from disk as in JAX.

On a CUDA device the prefetch thread also uploads: it pins the padded
arrays, copies them on a dedicated ``torch.cuda.Stream`` and records an
event there; before the pipeline call the main thread makes its current
stream wait on that event and marks the tensors as used by its stream
(``record_stream``), so the copy of video v+1 overlaps the compute of video
v and the caching allocator cannot hand the memory out early. On the CPU
the loader returns CPU tensors and no stream is involved.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.pipeline.fused import (
    FusedConfig,
    fused_to_protos,
    make_fused_pipeline,
    pad_snippet,
)
from vdetlib_tpu_torch.pipeline.runner import dump_config
from vdetlib_tpu_torch.protos import proto_dump, proto_exists
from vdetlib_tpu_torch.protos.arrays import box_proto_to_arrays
from vdetlib_tpu_torch.utils.log import StageMetrics, get_logger
from vdetlib_tpu_torch.video.link import path_counts

log = get_logger("pipeline.fused")

__all__ = ["FusedEngine", "fused_config_from_pipeline", "run_videos_fused"]


def fused_config_from_pipeline(cfg) -> FusedConfig:
    """Map a ``PipelineConfig`` onto the matched ``FusedConfig``.

    The fused program has ONE output budget where the staged path has two
    (rescore.max_boxes / link.max_boxes): the link budget wins."""
    if cfg.rescore.max_boxes != cfg.link.max_boxes:
        log.warning(
            "fused engine uses one output budget: link.max_boxes=%d "
            "(rescore.max_boxes=%d ignored)",
            cfg.link.max_boxes, cfg.rescore.max_boxes,
        )
    return FusedConfig(
        image_hw=tuple(cfg.detect.image_hw),
        detect_batch=cfg.detect.batch_size,
        feat_batch=cfg.track.batch_size,
        score_thresh=cfg.detect.score_thresh,
        mgp_window=cfg.mgp.window,
        mgp_decay=cfg.mgp.score_decay,
        nms_thresh=cfg.mgp.nms_thresh,
        det_budget=cfg.mgp.max_boxes,
        out_budget=cfg.link.max_boxes,
        max_tracks=cfg.track.max_tracks,
        anchors_per_round=cfg.track.anchors_per_round,
        anchor_thresh=cfg.track.anchor_thresh,
        track_conf=cfg.track.conf_thresh,
        cover_thresh=cfg.track.cover_thresh,
        snap_weight=cfg.track.snap_weight,
        snap_iou=cfg.track.snap_iou,
        track_stride=cfg.track.frame_stride,
        rescore_match=cfg.rescore.match_thresh,
        top_ratio=cfg.rescore.top_ratio,
        boost=cfg.rescore.boost,
        bg_decay=cfg.rescore.bg_decay,
        min_matched_frac=cfg.rescore.min_matched_frac,
        stat_floor=cfg.rescore.stat_floor,
        link_thresh=cfg.link.link_thresh,
        suppress_thresh=cfg.link.suppress_thresh,
        max_paths=cfg.link.max_paths,
        link_rescore=cfg.link.rescore,
        tubelet_boxes=cfg.rescore.tubelet_boxes,
        flow_preset=cfg.mgp.flow_preset,
        flow_levels=cfg.mgp.flow_levels,
        flow_search=cfg.mgp.flow_search,
    )


class Loaded(NamedTuple):
    """One video, decoded, padded and (on a card) uploaded by :meth:`FusedEngine.load`."""

    fids: list
    frames: torch.Tensor  # (Tp, H, W, 3) uint8
    rois: torch.Tensor  # (Tp, R, 4) float32, network pixels
    mask: torch.Tensor  # (Tp, R) bool
    t_valid: int
    inv: np.ndarray  # (4,) network → native pixels
    ready: Optional[torch.cuda.Event]  # the upload's event (None on the CPU)


class FusedEngine:
    """The fused pipeline plus per-video decode, upload and proto conversion."""

    def __init__(self, models, cfg, bucket: int = 32, group_size: int = 1):
        self.models = models
        self.fcfg = fused_config_from_pipeline(cfg)
        self.max_rois = cfg.detect.max_rois
        self.min_score = cfg.link.min_score
        # the padded T must be a multiple of the detect batch
        b = self.fcfg.detect_batch
        self.bucket = ((max(bucket, b) + b - 1) // b) * b
        self.pipe = make_fused_pipeline(models.detector, models.tracker, cfg.tracker_cfg,
                                        self.fcfg)
        self.group_size = max(1, group_size)
        self.device = next(models.detector.parameters()).device
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

    def load(self, vid_proto: dict, box_proto: Optional[dict], frames=None) -> Loaded:
        """Host side (the prefetch thread): decode or take the frames, pack and
        scale the proposals, pad to the bucket, upload (span ``runner.load``)."""
        with record_function("runner.load"):
            if box_proto is None:
                raise ValueError(
                    f"{vid_proto['video']}: fused engine needs proposals (box_proto); "
                    f"run the staged engine for proposal-free flows"
                )
            H, W = self.fcfg.image_hw
            fids = [f["frame"] for f in vid_proto["frames"]]
            loader = FrameLoader(vid_proto, target_hw=(H, W), frames=frames)
            imgs, scales = [], []
            try:
                for _, img, scale in loader.iter_frames():
                    imgs.append(img)
                    scales.append(scale)
            finally:
                loader.close()
            sy, sx = scales[0]
            if any(s != (sy, sx) for s in scales):
                raise ValueError(
                    f"{vid_proto['video']}: fused engine needs a constant frame size within a "
                    f"video (got varying decode scales)"
                )
            rois, roi_mask = box_proto_to_arrays(box_proto, fids, self.max_rois)
            rois = rois * np.array([sx, sy, sx, sy], np.float32)
            frames_p, rois_p, t_valid = pad_snippet(np.stack(imgs), rois, self.bucket)
            mask_p = np.zeros((frames_p.shape[0], self.max_rois), bool)
            mask_p[: roi_mask.shape[0]] = roi_mask
            inv = np.array([1 / sx, 1 / sy, 1 / sx, 1 / sy], np.float32)
            (frames_t, rois_t, mask_t), ready = self._upload(frames_p, rois_p, mask_p)
            return Loaded(fids, frames_t, rois_t, mask_t, t_valid, inv, ready)

    def _upload(self, *arrays):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self._copy_stream is None:
            return tensors, None
        with torch.cuda.stream(self._copy_stream):
            out = [t.pin_memory().to(self.device, non_blocking=True) for t in tensors]
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return out, ready

    def _to_protos(self, vid_proto, fids, inv, out):
        """Back to native pixel space, trimmed to the real frames (span
        ``runner.protos``) → (det_proto, tubelets, counters); the counters
        come from the host copies the conversion makes."""
        T = len(fids)
        with record_function("runner.protos"):
            out = out._replace(
                det_boxes=out.det_boxes[:T].cpu() * torch.from_numpy(inv),
                det_scores=out.det_scores[:T],
                det_mask=out.det_mask[:T],
                final_scores=out.final_scores[:, :T],
                path_ids=out.path_ids[:, :T].cpu(),
            )
            det_proto, tubelets = fused_to_protos(out, fids, vid_proto["video"],
                                                  min_score=self.min_score)
        counters = {"frames": T, "final_dets": len(det_proto["detections"]),
                    "tubelets": len(tubelets["tracks"]),
                    **path_counts(out.path_ids.numpy(), self.fcfg.max_paths)}
        return det_proto, tubelets, counters

    def run(self, vid_proto, loaded: Loaded):
        """The pipeline and the proto conversion for one loaded video →
        (det_proto, tubelets, counters): see :func:`run_videos_fused`."""
        if loaded.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(loaded.ready)
            for t in (loaded.frames, loaded.rois, loaded.mask):
                t.record_stream(stream)
        out = self.pipe(loaded.frames, loaded.rois, loaded.t_valid, loaded.mask)
        return self._to_protos(vid_proto, loaded.fids, loaded.inv, out)

    def run_group(self, vid_protos, loadeds):
        """A group of same-bucket videos, one after another through the same
        pipeline (see the module docstring); a list of :meth:`run`'s results."""
        return [self.run(v, ld) for v, ld in zip(vid_protos, loadeds)]


def run_videos_fused(workdir: str, video_inputs, models, cfg, group_size: int = 1,
                     keep_going: bool = False) -> list[dict]:
    """The sweep over ``video_inputs``: entries ``(vid_proto, box_proto)`` or
    ``(vid_proto, box_proto, frames)``; returns one dict of output paths per
    entry (``"error"`` set where a video failed under ``keep_going``).

    A written video's dict carries its ``counters``: ``frames`` (valid
    frames), ``final_dets`` and ``tubelets`` (the entries of its two protos),
    and seq-NMS's ``paths``, ``path_iters_live`` and ``path_iters_run``
    (``video/link.py::path_counts``). Metrics
    (``StageMetrics("pipeline_fused")``): those counters summed over the
    written videos, ``videos`` (entries not skipped) and ``prefetch_wait_s``
    (seconds the main thread waited for the prefetch thread).

    Spans (``torch.profiler.record_function``): ``runner.load`` on the
    prefetch thread, and on the calling thread ``runner.wait`` (the wait for
    a load), the pipeline's ``fused.pipeline``, ``runner.protos`` and
    ``runner.write`` (a video's directory and both protos)."""
    metrics = StageMetrics("pipeline_fused")
    dump_config(workdir, cfg)
    engine = FusedEngine(models, cfg, group_size=group_size)
    results = []
    wait_s = 0.0

    def paths_for(vid_proto):
        vdir = os.path.join(workdir, vid_proto["video"])
        return {
            "video": vid_proto["video"],
            "final": os.path.join(vdir, "final.json"),
            "tubelets": os.path.join(vdir, "tubelets.json"),
            "result": os.path.join(vdir, "final.json"),
        }

    todo = []
    for vid_proto, box_proto, *frames in video_inputs:
        p = paths_for(vid_proto)
        results.append(p)
        if proto_exists(p["final"]):
            log.info("skip %s (final exists)", vid_proto["video"])
            continue
        todo.append((vid_proto, box_proto, frames[0] if frames else None, p))

    G = engine.group_size
    groups = [todo[i: i + G] for i in range(0, len(todo), G)]
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = None
        for gi, group in enumerate(groups):
            if futs is None:
                futs = [ex.submit(engine.load, v, b, fr) for v, b, fr, _ in group]
            loadeds = []
            kept_group = []
            for entry, f in zip(group, futs):
                t0 = time.perf_counter()
                try:
                    with record_function("runner.wait"):
                        loadeds.append(f.result())
                    kept_group.append(entry)
                except Exception as e:
                    if not keep_going:
                        raise
                    log.warning("fused %s FAILED to load (%s: %s) — continuing (--keep_going)",
                                entry[0]["video"], type(e).__name__, e)
                    entry[3]["error"] = f"{type(e).__name__}: {e}"
                finally:
                    wait_s += time.perf_counter() - t0
            group = kept_group
            futs = ([ex.submit(engine.load, v, b, fr) for v, b, fr, _ in groups[gi + 1]]
                    if gi + 1 < len(groups) else None)
            # one run_group per same-bucket run within the group
            start = 0
            while start < len(group):
                tp = loadeds[start].frames.shape[0]
                end = start
                while end < len(group) and loadeds[end].frames.shape[0] == tp:
                    end += 1
                try:
                    outs = engine.run_group([g[0] for g in group[start:end]],
                                            loadeds[start:end])
                except Exception as e:
                    if not keep_going:
                        raise
                    for vid_proto, _, _, p in group[start:end]:
                        log.warning("fused %s FAILED (%s: %s) — continuing (--keep_going)",
                                    vid_proto["video"], type(e).__name__, e)
                        p["error"] = f"{type(e).__name__}: {e}"
                    start = end
                    continue
                for (vid_proto, _, _, p), (det_proto, tubelets, counters) in zip(
                        group[start:end], outs):
                    with record_function("runner.write"):
                        os.makedirs(os.path.dirname(p["final"]), exist_ok=True)
                        proto_dump(tubelets, p["tubelets"])
                        proto_dump(det_proto, p["final"])
                    p["counters"] = counters
                    for name, value in counters.items():
                        metrics.add(name, value)
                    log.info("fused %s: %d frames, %d final dets, %d tubelets",
                             vid_proto["video"], counters["frames"], counters["final_dets"],
                             counters["tubelets"])
                start = end

    metrics.set("videos", len(todo))
    metrics.set("prefetch_wait_s", wait_s)
    metrics.finish()
    return results
