"""The stream engine as the ``stream`` tool runs it: ``video/stream.py::
stream_video`` over synthetic videos fed back to back in chunks.

Set-up: the kernels built, the models with seeded weights, the queue's
videos drawn on the device, one short warm-up clip (a full chunk and a
partial one). Window: videos streamed one after another, as fast as they
are processed, started until ``--seconds`` have passed. A chunk's latency
runs from the engine's pull of it from the benchmark's iterator to the
engine's next pull; the pull after a video's last chunk ends that chunk,
and the video-end linking runs after it, inside the window but outside
every chunk. ``stream_frames_per_s`` is the frames of every video of the
window over the window, from its start to the last video's end, its
video-end linking included; ``stream.chunk_ms_p90``, a per-layer metric,
is the 90th percentile over every full chunk of the window. With
``--trace 1`` a traced run of the pool's median-length video follows the
window. Then the program's models are
freed and the reference checks ``check_videos`` finished videos (the
longest among them): the emissions and the linking whole, the tracker
step by step from the program's states, the seeds against the emissions.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from portbench.engines.fused_sweep import make_queue, median_video, pick_checked
from portbench.harness import compare
from portbench.harness.common import judge
from portbench.harness.models import program_models, reference_models


def stream_options(config: dict):
    from vdetlib_tpu_torch.video.stream import StreamOptions

    return StreamOptions(**config["stream"])


def feed(frames: np.ndarray, chunk: int, stamps: list):
    """Chunks of ``frames``; each pull's time goes to ``stamps``, and one more
    when the engine asks past the last chunk."""
    for s in range(0, frames.shape[0], chunk):
        stamps.append(time.perf_counter())
        yield frames[s:s + chunk]
    stamps.append(time.perf_counter())


def stream_one(det, trk, trk_cfg, opts, frames, rois):
    """One video through ``stream_video`` → (result, chunk latencies in ms,
    chunk lengths)."""
    from vdetlib_tpu_torch.video.stream import stream_video

    stamps = []
    res = stream_video(det, trk, trk_cfg, feed(frames, opts.chunk, stamps), rois, opts)
    lat = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    sizes = [min(opts.chunk, frames.shape[0] - s) for s in range(0, frames.shape[0], opts.chunk)]
    return res, lat, sizes


def check_video(rdet, rtrk, config, frames, rois, res) -> dict:
    """The reference's numbers for one streamed video."""
    from portbench.reference.stream import stream_emissions, track_steps, video_features

    sopts = types.SimpleNamespace(**config["stream"])
    chk = config["check"]
    ref = stream_emissions(rdet, sopts, frames, rois)
    nums = compare.emissions(res, ref, chk["box_px"], chk["score"])
    steps = compare.stream_track_steps(res["tracks"], frames.shape[0], sopts.chunk)
    feats = video_features(rtrk, frames, config["feat_batch"])
    b, p = track_steps(rtrk, feats, [s[:4] for s in steps])
    nums.update(compare.track_steps(steps, b, p, sopts.conf_thresh))
    nums.update(compare.seeds(res["tracks"], res, sopts.seed_thresh))
    nums["tracks"] = len(res["tracks"])
    nums["kept"] = int(res["keep"].sum())
    return nums


def valid_counts(res: dict, rois: int):
    """Per chunk frame and class: native slots over 0.01 (``stream.nms``'s
    valid slots) and slots over 0 (a superset of the MGP dedup's)."""
    s = res["scores"]
    return (s[:, :, :rois] > 0.01).sum(-1).ravel(), (s > 0).sum(-1).ravel()


def run(cell, args, device, t0: float) -> dict:
    from vdetlib_tpu_torch.kernels import build

    config, mix = cell.config, cell.traffic
    if device.type == "cuda":
        build.build_all()
    det, trk, trk_cfg, det_state, trk_state = program_models(config, args.seed, device)
    opts = stream_options(config)
    pool = make_queue(config, mix, args.seed, device)
    warm = mix["warmup_frames"]
    stream_one(det, trk, trk_cfg, opts, pool[0][0][:warm], pool[0][1][:warm])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    done, full_ms, k = [], [], 0
    cpu0 = time.process_time()
    start = time.perf_counter()
    while time.perf_counter() - start < args.seconds:
        i = k % len(pool)
        res, lat, sizes = stream_one(det, trk, trk_cfg, opts, *pool[i])
        full_ms += [ms for ms, n in zip(lat, sizes) if n == opts.chunk]
        done.append((res, i))
        k += 1
    window_s, cpu_s = time.perf_counter() - start, time.process_time() - cpu0

    context = None
    if args.trace:
        from portbench.harness.trace import capture

        i = median_video(pool)
        (res, lat, sizes), trace = capture(
            lambda: stream_one(det, trk, trk_cfg, opts, *pool[i]))
        nms_valid, mgp_valid = valid_counts(res, opts.max_rois)
        context = {"trace": trace, "config": config, "chunks_ms": full_ms,
                   "window_frames": [pool[i][0].shape[0] for _, i in done], "window_s": window_s,
                   "traced_chunks_ms": lat, "traced_chunk_sizes": sizes,
                   "nms_valid": nms_valid.tolist(), "mgp_valid": mgp_valid.tolist()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if context is not None:
        context["peak_mem_bytes"] = peak

    del det, trk
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rdet, rtrk = reference_models(config, det_state, trk_state, device)
    by_name = {f"s{n:05d}": d for n, d in enumerate(done)}
    worst = {"emit_mismatch": 0.0, "link_mismatch": 0.0, "track_box_gap_px": 0.0,
             "track_peak_gap": 0.0, "seed_gap": 0.0, "empty_checked": 0}
    for name, i in pick_checked([(n, d[1]) for n, d in by_name.items()], pool,
                                mix["check_videos"], args.seed):
        nums = check_video(rdet, rtrk, config, *pool[i], by_name[name][0])
        for key in worst:
            if key != "empty_checked":
                worst[key] = max(worst[key], nums[key])
        worst["empty_checked"] += nums["tracks"] == 0 or nums["kept"] == 0
    correct, checks = judge(worst, config["check"]["limits"])
    frames = sum(pool[i][0].shape[0] for _, i in done)
    return {"end_to_end": {"stream_frames_per_s": frames / window_s, "setup_s": setup_s},
            "counts": {"frames": frames, "full_chunks": len(full_ms), "videos": len(done),
                       "window_s": window_s, "cpu_s": cpu_s,
                       "chunk_ms_p90": float(np.percentile(full_ms, 90)) if full_ms else None},
            "correct": correct, "checks": checks, "attempted": len(done), "failed": 0,
            "memory_peak_bytes": peak, "context": context}
