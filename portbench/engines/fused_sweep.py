"""The fused engine's offline sweep: ``pipeline/fused_runner.py::run_videos_fused``
over shards of a queue of synthetic videos, configured as ``serve --engine
fused`` builds it (``cli/serve.py::serve_config``).

Set-up: the kernels built, the models with seeded weights, the queue's
videos and proposals drawn on the device, one short warm-up clip through the
sweep. Window: shards of ``shard_videos`` videos, one ``run_videos_fused``
call each, started until ``--seconds`` have passed; ``frames_per_s`` is the
finished shards' valid frames over the time from the window's start to the
last shard's end. Each video's tracks, which the pipeline returns to the
runner and the runner does not write, are kept by reference
(:func:`recorded_tracks`). With ``--trace 1`` a traced shard of the pool's median-length
video follows the window. Then the program's models are
freed and the reference recomputes ``check_videos`` finished videos (the
longest among them), each by :func:`check_video`. The tracker's rollouts
are chaotic (a last-bit difference grows into pixels over a track), so the
reference follows the program's own tracks: it checks each tracker step
from the program's previous box and each track's anchor by itself, and
recomputes everything else, with the program's tracks in the place of its
own, up to the final detections.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
import types
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from portbench.harness import compare, videos
from portbench.harness.common import judge
from portbench.harness.models import program_models, reference_models


def serve_pipeline_config(config: dict):
    """The ``PipelineConfig`` of ``serve`` for the configuration's flags, held
    to the configuration file's ``fused`` fields."""
    from vdetlib_tpu_torch.cli.serve import parse_args, serve_config
    from vdetlib_tpu_torch.pipeline.fused_runner import fused_config_from_pipeline

    cfg = serve_config(parse_args(["queue", "workdir"] + config["serve_args"]))
    fused = fused_config_from_pipeline(cfg)
    got = {k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(fused).items()}
    diff = {k: (got.get(k), v) for k, v in config["fused"].items() if got.get(k) != v}
    diff.update({k: (v, None) for k, v in got.items() if k not in config["fused"]})
    if diff:
        raise SystemExit(f"serve's fused config is not the configuration's: {diff}")
    return cfg


def make_queue(config: dict, mix: dict, seed: int, device):
    """The queue's pool: one video of each of the mix's lengths, in its order,
    each drawn from its own seed → list of (frames, rois) numpy."""
    return [videos.make_video(mix, config["image_hw"], T, videos.video_seed(seed, i),
                              config["max_rois"], device)
            for i, T in enumerate(videos.queue_lengths(mix))]


def entries(names, pool_ids, pool, boxes):
    """The sweep's entries (vid_proto, box_proto, frames); ``boxes`` holds each
    pool video's box_proto, made in set-up."""
    return [(videos.vid_proto(n, pool[i][0].shape[0]), boxes[i], pool[i][0])
            for n, i in zip(names, pool_ids)]


def reference_video(det, trk, config, frames, rois, tracks=None):
    """The reference's arrays of one video (see ``reference/fused.py::
    fused_video``), trimmed to its real frames; ``tracks``: a video's tracks
    as :func:`recorded_tracks` keeps them, put in the place of the
    reference's own."""
    from portbench.reference.fused import fused_video, pad_snippet

    fcfg = types.SimpleNamespace(**config["fused"])
    dev = next(det.parameters()).device
    fp, rp, t_valid = pad_snippet(frames, rois, config["bucket"])
    mask = np.zeros(rp.shape[:2], bool)
    mask[:t_valid] = True
    given = None if tracks is None else (tracks[0].to(dev), tracks[2].to(dev))
    out = fused_video(det, trk, fcfg, torch.from_numpy(fp).to(dev), torch.from_numpy(rp).to(dev),
                      t_valid, torch.from_numpy(mask).to(dev), given)
    return {"boxes": out["boxes"][:t_valid], "mask": out["mask"][:t_valid],
            "final": out["final"][:, :t_valid], "track_boxes": out["track_boxes"],
            "track_conf": out["track_conf"], "track_alive": out["track_alive"], "cand_boxes": out["cand_boxes"][:t_valid],
            "cand_mask": out["cand_mask"][:t_valid]}


@contextmanager
def recorded_tracks(store: dict):
    """Keep each video's tracks as the fused pipeline returns them to the
    runner: ``store[video] = (track_boxes, track_conf, track_alive,
    n_tracks, t_valid)``, copied on the device as they come (four small
    copies a video, no wait), so that a later call cannot overwrite them."""
    from vdetlib_tpu_torch.pipeline.fused import FusedPipeline
    from vdetlib_tpu_torch.pipeline.fused_runner import FusedEngine

    run, call = FusedEngine.run, FusedPipeline.__call__
    current = {}

    def run_named(self, vid_proto, loaded):
        current["video"], current["t_valid"] = vid_proto["video"], loaded.t_valid
        return run(self, vid_proto, loaded)

    def call_kept(self, *a, **k):
        out = call(self, *a, **k)
        store[current["video"]] = (out.track_boxes.clone(), out.track_conf.clone(),
                                   out.track_alive.clone(), out.n_tracks.clone(),
                                   current["t_valid"])
        return out

    with mock.patch.object(FusedEngine, "run", run_named), \
            mock.patch.object(FusedPipeline, "__call__", call_kept):
        yield store


def track_numbers(rtrk, config: dict, frames, tracks) -> dict:
    """The program's tracker steps of one video (``tracks`` as
    :func:`recorded_tracks` keeps them) against the reference's recomputation
    of each step from the program's previous box."""
    from portbench.reference.stream import track_steps, video_features

    f = config["fused"]
    boxes, conf, alive, n, t_valid = tracks
    s = f["track_stride"]
    steps = compare.fused_track_steps(boxes.cpu().numpy(), conf.cpu().numpy(),
                                      alive.cpu().numpy(), int(n), t_valid, s)
    feats = video_features(rtrk, frames[:t_valid:s], f["feat_batch"])
    b, pk = track_steps(rtrk, feats, [st[:4] for st in steps])
    nums = compare.track_steps(steps, b, pk, f["track_conf"])
    nums["tracks"] = int(n)
    return nums


def check_numbers(prog_entries: list, ref: dict, config: dict, min_score: float) -> dict:
    """Final detections of one video against the reference's; ``min_score``
    is serve's (``cfg.link.min_score``), below which ``final.json`` lists no
    score."""
    chk = config["check"]
    return compare.final_dets(prog_entries, compare.array_entries(ref, min_score),
                              chk["box_px"], chk["score"])


def check_video(rdet, rtrk, config: dict, frames, rois, final_path: str, tracks,
                min_score: float) -> dict:
    """The program's numbers for one video of the sweep: its ``final.json``
    against the reference's final detections, the reference run on the
    program's own tracks (``tracks``, as :func:`recorded_tracks` keeps them);
    those tracks' anchors against the reference's candidates; and each
    tracker step against the reference's recomputation from the program's
    previous box (:func:`track_numbers`)."""
    ref = reference_video(rdet, rtrk, config, frames, rois, tracks)
    nums = check_numbers(compare.proto_entries(final_path), ref, config, min_score)
    boxes, conf, _, n, t_valid = tracks
    nums.update(compare.anchor_gap(boxes.cpu().numpy(), conf.cpu().numpy(), int(n), t_valid,
                                   ref["cand_boxes"], ref["cand_mask"]))
    nums.update(track_numbers(rtrk, config, frames, tracks))
    return nums


def median_video(pool: list) -> int:
    """The pool index of the (lower) median-length video."""
    ids = sorted(range(len(pool)), key=lambda i: (pool[i][0].shape[0], i))
    return ids[(len(ids) - 1) // 2]


def pick_checked(finished: list, pool: list, n: int, seed: int) -> list:
    """Up to ``n`` finished (name, pool index) entries of distinct videos: the
    longest, then others drawn from the seed."""
    distinct = {}
    for name, i in finished:
        distinct.setdefault(i, name)
    ids = sorted(distinct, key=lambda i: -pool[i][0].shape[0])
    rest = list(np.random.default_rng(seed + 7).permutation(ids[1:])) if len(ids) > 1 else []
    chosen = ids[:1] + [int(i) for i in rest[: n - 1]]
    return [(distinct[i], i) for i in chosen]


def run(cell, args, device, t0: float) -> dict:
    from vdetlib_tpu_torch.kernels import build
    from vdetlib_tpu_torch.pipeline.fused_runner import run_videos_fused
    from vdetlib_tpu_torch.pipeline.runner import Models

    config, mix = cell.config, cell.traffic
    if device.type == "cuda":
        build.build_all()
    det, trk, _, det_state, trk_state = program_models(config, args.seed, device)
    models = Models(det, trk)
    cfg = serve_pipeline_config(config)
    pool = make_queue(config, mix, args.seed, device)
    boxes = [videos.box_proto("queue", rois) for _, rois in pool]
    work = tempfile.mkdtemp(prefix="portbench_", dir=os.environ.get("TMPDIR"))
    tracks = {}
    try:
        warm = mix["warmup_frames"]
        w_frames, w_rois = pool[0][0][:warm], pool[0][1][:warm]
        run_videos_fused(os.path.join(work, "warmup"),
                         [(videos.vid_proto("warmup", warm), videos.box_proto("warmup", w_rois),
                           w_frames)], models, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0

        finished, n_frames, shard, k = [], 0, mix["shard_videos"], 0
        cpu0 = time.process_time()
        start = time.perf_counter()
        while time.perf_counter() - start < args.seconds:
            ids = [(k + j) % len(pool) for j in range(shard)]
            names = [f"v{k + j:05d}" for j in range(shard)]
            with recorded_tracks(tracks):
                res = run_videos_fused(os.path.join(work, "window"),
                                       entries(names, ids, pool, boxes), models, cfg)
            if any("error" in r for r in res):
                raise RuntimeError(f"the sweep failed: {res}")
            n_frames += sum(pool[i][0].shape[0] for i in ids)
            finished += list(zip(names, ids))
            k += shard
        end = time.perf_counter()
        cpu_s = time.process_time() - cpu0

        context = None
        if args.trace:
            from portbench.harness.trace import capture

            i = median_video(pool)
            _, trace = capture(lambda: run_videos_fused(
                os.path.join(work, "traced"), entries(["traced"], [i], pool, boxes), models, cfg))
            T = pool[i][0].shape[0]
            context = {"trace": trace, "config": config,
                       "videos": [{"t": T, "tp": -(-T // config["bucket"]) * config["bucket"]}],
                       "window_frames": [pool[j][0].shape[0] for _, j in finished],
                       "window_s": end - start}
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if context is not None:
            context["peak_mem_bytes"] = peak

        del det, trk, models
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rdet, rtrk = reference_models(config, det_state, trk_state, device)
        worst = {"final_mismatch": 0.0, "anchor_gap_px": 0.0, "track_box_gap_px": 0.0,
                 "track_peak_gap": 0.0, "empty_checked": 0}
        for name, i in pick_checked(finished, pool, mix["check_videos"], args.seed):
            nums = check_video(rdet, rtrk, config, *pool[i],
                               os.path.join(work, "window", name, "final.json"), tracks[name],
                               cfg.link.min_score)
            for key in worst:
                if key != "empty_checked":
                    worst[key] = max(worst[key], nums[key])
            worst["empty_checked"] += nums["final_dets"] == 0 or nums["tracks"] == 0
        correct, checks = judge(worst, config["check"]["limits"])
        return {"end_to_end": {"frames_per_s": n_frames / (end - start), "setup_s": setup_s},
                "counts": {"frames": n_frames, "videos": len(finished), "window_s": end - start,
                           "cpu_s": cpu_s},
                "correct": correct, "checks": checks, "attempted": len(finished), "failed": 0,
                "memory_peak_bytes": peak, "context": context}
    finally:
        shutil.rmtree(work, ignore_errors=True)
