#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vdetlib_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each synchronised and each fatal on failure:

1. device: a CUDA device is required (no CPU fallback); TF32 is switched off
   for matmuls and convolutions, as the float32 reference computes;
2. build: both hand-written kernels of ``vdetlib_tpu_torch/csrc`` are
   compiled with nvcc (``vdetlib_tpu_torch/_build``) and loaded;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path (flow level: 255 pairs of 60×80 bf16, box-shift
   tolerance mean < 0.05 px, max < 0.5 px; grouped NMS: 256 frames × 192
   slots, 30 class groups, ties, invalid and padded slots, keep sets
   identical), both timed with CUDA events;
4. reference: the tiny float32 pipeline on the card equals the same pipeline
   on the CPU (plain kernel versions) within the port's cross-framework
   bounds (bool fields and n_tracks exact, path ids < 1% of slots, boxes
   0.5 px, scores 0.01);
5. slice: the ``base`` detector (C=31) and the default tracker with seeded
   random weights run ``pad_snippet`` → ``make_fused_pipeline`` →
   ``fused_to_protos`` at 240×320 over three synthetic videos; the kernels'
   launch counters are zeroed just before and read just after, and every
   kernel must have launched; outputs must be finite, with tracks, detections
   and seq-NMS paths.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 240, 320  # the bench workload (bench.py)
R, C, B, A = 64, 31, 32, 8
VIDEO_LENGTHS = (64, 50, 96)  # 50 pads to the 64-frame bucket


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_rois(T, seed, h=H, w=W, r=R):
    """Seeded proposals as in bench.py: 16..120 px boxes anywhere in the frame."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, w - 20, (T, r))
    y1 = rng.uniform(0, h - 20, (T, r))
    bw = rng.uniform(16, 120, (T, r))
    bh = rng.uniform(16, 120, (T, r))
    return np.stack([x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1)],
                    -1).astype(np.float32)


# ---------------------------------------------------------------- phase 3


def phase_kernels(dev):
    """Kernels vs plain versions at main-path shapes → kernel records."""
    from vdetlib_tpu.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.kernels import flow as tflow
    from vdetlib_tpu_torch.kernels import flow_level as kl
    from vdetlib_tpu_torch.kernels import nms_grouped as kb

    # kernel A: the quarter-res gray pairs of a 256-frame video
    sv = make_video(SynthConfig(num_frames=256, height=H, width=W, num_classes=4, seed=0))
    frames = torch.from_numpy(sv.frames).to(dev)
    gray = tflow._avg_pool2(tflow._avg_pool2(tflow.to_gray(frames))).to(torch.bfloat16)
    i1, i2 = gray[:-1].contiguous(), gray[1:].contiguous()
    got = kl.flow_level(i1, i2)
    want = kl._flow_level(i1, i2)
    torch.cuda.synchronize()
    boxes = torch.from_numpy(sv.gt_boxes[:, :255].transpose(1, 0, 2).copy()).to(dev)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
    scale = tflow.flow_coord_scale("fastest")
    d = (tflow.mean_flow_in_boxes(got, boxes * scale, valid)
         - tflow.mean_flow_in_boxes(want, boxes * scale, valid)).abs() / scale  # full-res px
    flow_err, flow_mean = float(d.max()), float(d.mean())
    field_err = float((got - want).abs().max())
    log(f"kernel flow_level {tuple(i1.shape)} bf16: box-shift err mean {flow_mean:.6f} "
        f"max {flow_err:.6f} px (tolerance mean < 0.05, max < 0.5); "
        f"field max |diff| {field_err:.6f} cells")
    assert math.isfinite(flow_err) and flow_mean < 0.05 and flow_err < 0.5, "flow kernel disagrees"
    flow_ms = cuda_ms(lambda: kl.flow_level(i1, i2), iters=20)
    flow_plain_ms = cuda_ms(lambda: kl._flow_level(i1, i2), iters=5)

    # kernel B: the MGP dedup problem, 256 frames x 192 slots (3 x 64 budget)
    rng = np.random.default_rng(1)
    Tn, N, pad = 256, 192, 20
    x1 = rng.uniform(0, W - 20, (Tn, N))
    y1 = rng.uniform(0, H - 20, (Tn, N))
    bw = rng.uniform(16, 120, (Tn, N))
    bh = rng.uniform(16, 120, (Tn, N))
    nb = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    nb[:, 64:128] = nb[:, :64] + rng.normal(0, 3, (Tn, 64, 4)).astype(np.float32)  # hop copies
    ns = (rng.integers(0, 25, (Tn, N)) / 25.0).astype(np.float32)  # many exact ties
    ns[:, 1::5] = ns[:, 0::5][:, : ns[:, 1::5].shape[1]]
    ng = rng.integers(1, C, (Tn, N)).astype(np.int32)
    nv = rng.uniform(size=(Tn, N)) > 0.15
    nv[:, N - pad:] = False
    ng[:, N - pad:] = -1
    args = [torch.from_numpy(a).to(dev) for a in (nb, ns, nv, ng)]
    keep = kb.nms_grouped_kernel(*args, 0.3)
    ref = kb.nms_unsorted_fixpoint(args[0], args[1], args[2], 0.3, groups=args[3])
    torch.cuda.synchronize()
    n_diff = int((keep != ref).sum())
    log(f"kernel nms_grouped ({Tn}, {N}): {n_diff} slots differ from the plain version "
        f"(kept {int(keep.sum())} of {int(args[2].sum())} valid; tolerance: identical)")
    assert n_diff == 0, "grouped NMS kernel disagrees"
    nms_ms = cuda_ms(lambda: kb.nms_grouped_kernel(*args, 0.3), iters=50)
    nms_plain_ms = cuda_ms(
        lambda: kb.nms_unsorted_fixpoint(args[0], args[1], args[2], 0.3, groups=args[3]), iters=10)
    log(f"times (ms/call, CUDA events): flow kernel {flow_ms:.4f} plain {flow_plain_ms:.4f}; "
        f"nms kernel {nms_ms:.4f} plain {nms_plain_ms:.4f}")
    return {
        "flow_level": dict(
            name="flow_level", route="cuda", source="vdetlib_tpu_torch/csrc/flow_level.cu",
            replaces="vdetlib_tpu/kernels/flow_pallas.py:104", max_abs_err=flow_err,
            ms=flow_ms, plain_ms=flow_plain_ms),
        "nms_grouped": dict(
            name="nms_grouped", route="cuda", source="vdetlib_tpu_torch/csrc/nms_grouped.cu",
            replaces="vdetlib_tpu/kernels/nms_pallas.py:261", max_abs_err=float(n_diff),
            ms=nms_ms, plain_ms=nms_plain_ms),
    }


# ---------------------------------------------------------------- phase 4


def tiny_pipeline(dev, seed=0):
    """The tiny preset at 96×128 in float32 (detector and tracker) on ``dev``."""
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig, make_fused_pipeline
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset("tiny", num_classes=4, dtype=torch.float32),
                        torch.Generator().manual_seed(seed))
    det.head.dtype = det.head.fc0.dtype = torch.float32
    with torch.no_grad():
        det.head.bbox.weight.mul_(0.1)  # a trained regressor's delta scale
    trk_cfg = TrackerConfig(dtype=torch.float32)
    trk = init_tracker(trk_cfg, torch.Generator().manual_seed(seed + 1))
    cfg = FusedConfig(image_hw=(96, 128), detect_batch=8, feat_batch=8, anchors_per_round=4,
                      max_tracks=8, max_paths=16, det_budget=24, out_budget=24,
                      score_thresh=0.2, anchor_thresh=0.26)
    return make_fused_pipeline(det.to(dev), trk.to(dev), trk_cfg, cfg)


def tiny_inputs(seed=5, T=16):
    from vdetlib_tpu.data.synth import SynthConfig, make_video

    sv = make_video(SynthConfig(num_frames=T, height=96, width=128, num_classes=4, seed=seed))
    rng = np.random.default_rng(seed)
    k = rng.integers(0, sv.gt_boxes.shape[0], (T, 16))
    rois = sv.gt_boxes[k, np.arange(T)[:, None]] + rng.normal(0, 4, (T, 16, 4))
    rois = np.clip(rois, 0, [127, 95, 127, 95]).astype(np.float32)
    roi_mask = np.arange(16)[None] < 16 - rng.integers(0, 6, (T, 1))
    return sv.frames, rois, roi_mask


def compare_outputs(got, want):
    """The port's cross-framework bounds; returns the worst float error."""
    tol = {"det_boxes": 0.5, "track_boxes": 0.5, "det_scores": 0.01, "track_conf": 0.01,
           "tubelet_stats": 0.01, "final_scores": 0.01}
    worst = 0.0
    for name in want._fields:
        g = getattr(got, name).cpu().numpy()
        w = getattr(want, name).cpu().numpy()
        assert g.shape == w.shape, name
        if w.dtype == bool or name == "n_tracks":
            assert np.array_equal(g, w), f"{name} differs"
        elif name == "path_ids":
            assert (g != w).mean() < 0.01, f"path_ids differ on {(g != w).mean():.2%}"
        else:
            m = np.ones(w.shape, bool)
            if name == "det_boxes":
                m = want.det_mask.cpu().numpy()
            elif name == "track_boxes":
                m = want.track_alive.cpu().numpy()
            err = float(np.abs(g[m] - w[m]).max()) if m.any() else 0.0
            assert err <= tol[name], f"{name} differs by {err}"
            worst = max(worst, err)
    return worst


def phase_reference(dev):
    frames, rois, roi_mask = tiny_inputs()
    with torch.no_grad():
        want = tiny_pipeline("cpu")(*(torch.from_numpy(a) for a in (frames, rois)), None,
                                    torch.from_numpy(roi_mask))
        got = tiny_pipeline(dev)(*(torch.from_numpy(a).to(dev) for a in (frames, rois)), None,
                                 torch.from_numpy(roi_mask).to(dev))
    torch.cuda.synchronize()
    worst = compare_outputs(got, want)
    assert int(want.n_tracks) >= 1 and bool(want.det_mask.any())
    log(f"reference: tiny f32 pipeline on {dev} == CPU within bounds "
        f"(worst float diff {worst:.6f}, n_tracks {int(want.n_tracks)})")


# ---------------------------------------------------------------- phase 5


def base_pipeline(dev, seed=0):
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig, make_fused_pipeline
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset("base", num_classes=C),
                        torch.Generator().manual_seed(seed), device=dev)
    trk_cfg = TrackerConfig()
    trk = init_tracker(trk_cfg, torch.Generator().manual_seed(seed + 1), device=dev)
    cfg = FusedConfig(image_hw=(H, W), detect_batch=B, feat_batch=B, anchors_per_round=A,
                      max_tracks=A, max_paths=32)
    return make_fused_pipeline(det, trk, trk_cfg, cfg)


def slice_inputs(T, seed):
    from vdetlib_tpu.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.pipeline.fused import pad_snippet

    sv = make_video(SynthConfig(num_frames=T, height=H, width=W, num_classes=4, seed=seed))
    frames, rois, t_valid = pad_snippet(sv.frames, make_rois(T, seed), bucket=32)
    roi_mask = np.arange(frames.shape[0])[:, None] < t_valid
    return frames, rois, t_valid, np.broadcast_to(roi_mask, rois.shape[:2]).copy(), sv.frame_ids


def calibrated_anchor_thresh(pipe, dev, videos):
    """Random weights give near-uniform class scores (about 1/C): when no
    budgeted detection of some video reaches ``anchor_thresh``, lower it to
    the smallest over the videos of the 95th percentile of their budgeted
    scores, so that every video's tracker gets anchors."""
    from vdetlib_tpu_torch.pipeline.fused import _rank_mask

    cfg = pipe.cfg
    qs, tops = [], []
    for frames, rois, t_valid, roi_mask, _ in videos:
        with torch.no_grad():
            probs, _ = pipe.detect(torch.from_numpy(frames).to(dev),
                                   torch.from_numpy(rois).to(dev))
        s = probs[:t_valid, :, 1:].reshape(t_valid, -1)
        kept, _ = _rank_mask(s >= cfg.score_thresh, cfg.det_budget)
        cand = s[kept].float()
        tops.append(float(cand.max()))
        qs.append(float(torch.quantile(cand, 0.95)))
    if min(tops) >= cfg.anchor_thresh:
        return None
    thresh = min(qs)
    log(f"some video has no budgeted detection at anchor_thresh={cfg.anchor_thresh} with "
        f"random weights (per-video max {[round(t, 4) for t in tops]}); anchor_thresh "
        f"lowered to {thresh:.6f}")
    return thresh


def phase_slice(dev, kernels, profile_dir=None):
    """The base-width slice over the synthetic videos; ``kernels`` maps each
    kernel's name to its wrapper, whose launch counter is read around the run."""
    from vdetlib_tpu_torch.pipeline.fused import fused_to_protos, make_fused_pipeline

    videos = [slice_inputs(T, seed) for seed, T in enumerate(VIDEO_LENGTHS)]
    pipe = base_pipeline(dev)
    thresh = calibrated_anchor_thresh(pipe, dev, videos)
    if thresh is not None:
        pipe = make_fused_pipeline(pipe.det_model, pipe.trk_model, pipe.trk_cfg,
                                   dataclasses.replace(pipe.cfg, anchor_thresh=thresh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    times, n_frames = [], 0
    for i, (frames, rois, t_valid, roi_mask, fids) in enumerate(videos):
        args = [torch.from_numpy(a).to(dev) for a in (frames, rois)]
        mask = torch.from_numpy(roi_mask).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipe(*args, t_valid, mask)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        det_proto, track_proto = fused_to_protos(out, fids, f"synth{i:03d}")
        times.append(dt)
        n_frames += t_valid
        floats = [out.det_boxes, out.det_scores, out.final_scores, out.track_boxes,
                  out.track_conf, out.tubelet_stats]
        assert all(bool(torch.isfinite(x).all()) for x in floats), "non-finite output"
        assert int(out.n_tracks) >= 1, "no tracks"
        assert bool(out.det_mask.any()), "no detections survive"
        assert bool((out.path_ids >= 0).any()), "no seq-NMS paths"
        assert len(det_proto["detections"]) > 0, "empty det_proto"
        assert out.det_boxes.shape == (frames.shape[0], pipe.cfg.out_budget, 4)
        log(f"video {i}: T={t_valid} (bucket {frames.shape[0]}) {dt * 1e3:.1f} ms, "
            f"n_tracks {int(out.n_tracks)}, det slots {int(out.det_mask.sum())}, "
            f"paths {int(out.path_ids.max()) + 1}, proto dets {len(det_proto['detections'])}, "
            f"tubelets {len(track_proto['tracks'])}")
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    steady = sum(VIDEO_LENGTHS[1:]) / sum(times[1:])
    log(f"slice: {n_frames} frames in {sum(times):.3f} s = {n_frames / sum(times):.2f} frames/s "
        f"(after the first video: {steady:.2f} frames/s); peak device memory "
        f"{peak / 2**20:.1f} MiB; kernel launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    if profile_dir:
        profile_one(pipe, dev, videos[-1], profile_dir)
    return launches, n_frames / sum(times), steady, peak


def profile_one(pipe, dev, video, out_dir):
    """One traced video: per-stage and per-kernel device time into ``out_dir``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    frames, rois, t_valid, roi_mask, _ = video
    args = [torch.from_numpy(a).to(dev) for a in (frames, rois)]
    mask = torch.from_numpy(roi_mask).to(dev)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            pipe(*args, t_valid, mask)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(table)
    spans = [e for e in prof.key_averages() if e.key.startswith("fused.")]
    for e in sorted(spans, key=lambda e: e.key):
        log(f"profile {e.key}: cpu {e.cpu_time_total / 1e3:.3f} ms, "
            f"device {e.device_time_total / 1e3:.3f} ms")


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="trace one video into DIR/profile.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from vdetlib_tpu_torch.kernels import build
    from vdetlib_tpu_torch.kernels.flow_level import flow_level
    from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    for name in build.KERNELS:
        t1 = time.perf_counter()
        build.load(name)
        log(f"build {name}: {time.perf_counter() - t1:.2f} s")
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build total: {time.perf_counter() - t0:.2f} s")

    records = phase_kernels(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    kernels = {"flow_level": flow_level, "nms_grouped": nms_grouped_kernel}
    launches, fps, steady, peak = phase_slice(dev, kernels, args.profile)
    torch.cuda.synchronize()
    log(f"slice throughput on {card}: {fps:.2f} frames/s overall, {steady:.2f} frames/s "
        f"steady; peak memory {peak / 2**20:.1f} MiB")
    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
