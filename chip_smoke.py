#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vdetlib_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each synchronised and each fatal on failure:

1. device: a CUDA device is required (no CPU fallback); TF32 is switched off
   for matmuls and convolutions, as the float32 reference computes;
2. build: every hand-written kernel of ``vdetlib_tpu_torch/csrc`` is
   compiled with nvcc (one process per source, all at once, into
   ``vdetlib_tpu_torch/_build``) and loaded;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of its path, all timed with CUDA events beside their bound:
   A, flow level: 32, 63, 95 and 255 pairs of 60×80 bf16 (the stream's
   chunk, the fused slice's buckets, a 256-frame video), box-shift
   tolerance mean < 0.05 px, max < 0.5 px at each; B, grouped NMS: 256
   frames × 192 slots, 30 class groups; C, batched NMS: the stream's 960 problems (32 frames × 30
   classes) of 64 slots; D, sorted NMS: 1,920 problems (64 frames × 30
   classes) of 512 slots. The NMS problems hold ties, invalid and padded
   slots, and their keep sets must be identical; E, resize + normalize: 96
   native 360×480 frames to 240×320 and 240×320 frames to the pyramid's
   176×240 and 304×400, abs <= 1e-3; F, tracker scan, on the staged
   tracker's features (48 × 90×120×96 bf16): one-step clips (T = 2, anchors
   at frame 0 and at frame 1, bf16 and float32 features; boxes <= 1e-3 px,
   peaks <= 1e-4, alive equal), a 16-step rollout (alive equal, live boxes
   < 0.1 px), both again at search windows of Q = 12 and 20 bins, and the
   48-step round (printed, not gated; timed in ms a round and µs a step,
   with its registers from the ptxas log and its shared memory);
4. reference: the tiny float32 fused pipeline (its tracker scan is kernel F
   on the card) and the tiny float32 stream on the card equal the same runs
   on the CPU (plain kernel versions) within the port's cross-framework
   bounds (bool fields exact, path ids < 1% of slots, boxes 0.5 px, scores
   0.01; stream track segments on the same frames);
5. fused slice: the ``base`` detector (C=31) and the default tracker with
   seeded random weights run ``pad_snippet`` → ``make_fused_pipeline`` →
   ``fused_to_protos`` at 240×320 over three synthetic videos; kernels A, B
   and F must launch;
6. stream: the same models run ``stream_video`` → ``stream_to_protos`` at
   the stream tool's defaults (chunk 32, 64 proposals, 16 track slots) over
   videos of 96 and 100 frames (the second ends in a partial chunk of 4);
   kernels A, B and C must launch;
7. frame NMS: ``frame_nms(backend="pallas")`` over synthetic protos of 64
   frames × 30 classes equals the ``host`` backend at 512 boxes (kernel D)
   and at 128 (kernel C);
8. staged detect → track: the same models through the stages' entry
   points at the detect and track tools' defaults, frames in memory:
   ``det_vid`` with ``device_resize`` over 96 native 360×480 frames with 128
   proposals each (batches of 8 resized to 240×320 by kernel E), ``det_vid``
   with the pyramid (0.75, 1.0, 1.25) over 96 frames at 240×320 (E for 0.75
   and 1.25), and ``track_from_det`` over the first det_proto (32 tracks, 8
   anchors a round, stride 2; kernel F once per round); kernels E and F
   must launch.

Around each of phases 5–8 the kernels' launch counters are zeroed just
before and read just after; a kernel's ``launches`` in the record is the
count from its own path (A, B: fused slice; C: stream; D: frame NMS; E, F:
staged path).

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
STREAM_LENGTHS = (96, 100)  # 100 ends in a partial chunk of 4
NMS_FRAMES = 64  # frame-NMS protos: 64 frames x 30 classes
# kernel A's pair counts: the stream's full chunk (32), the fused slice's
# two buckets (63, 95) and a 256-frame video (255, the record's time)
FLOW_PAIRS = (32, 63, 95, 255)
# the staged detect → track path: native frames resized on the card to
# (H, W) in the detect tool's batches with its proposal budget, and the
# pyramid's scaled sizes of (H, W)
NATIVE_HW = (360, 480)
STAGED_T, DETECT_B, STAGED_R = 96, 8, 128
PYRAMID = (0.75, 1.0, 1.25)
PYRAMID_HW = ((176, 240), (304, 400))

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations, counted from the plain versions' arithmetic:
# one IoU = 4 max/min + 2 sub + 2 add (offset) + 2 clamp + 1 mul + 1 add +
# 1 sub + 1 div + 1 compare; one box area = 2 sub + 2 add + 1 mul
IOU_OPS, AREA_OPS = 15, 5


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


def bound(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_rois(T, seed, h=H, w=W, r=R):
    """Seeded proposals as in bench.py: 16..120 px boxes anywhere in the frame."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, w - 20, (T, r))
    y1 = rng.uniform(0, h - 20, (T, r))
    bw = rng.uniform(16, 120, (T, r))
    bh = rng.uniform(16, 120, (T, r))
    return np.stack([x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1)],
                    -1).astype(np.float32)


def synth(T, seed, h=H, w=W):
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video

    return make_video(SynthConfig(num_frames=T, height=h, width=w, num_classes=4, seed=seed))


@functools.lru_cache(maxsize=None)
def staged_video(hw):
    """The staged path's native video: STAGED_T frames of 8 moving objects."""
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video

    return make_video(SynthConfig(num_frames=STAGED_T, height=hw[0], width=hw[1], num_objects=8,
                                  num_classes=4, seed=20), video="staged")


def staged_features(trk, frames, dev, stride=2, batch=16):
    """Tracker features of every ``stride``-th frame, as ``track_from_det``
    computes them at its defaults."""
    from vdetlib_tpu_torch.video.track import tracker_features

    x = torch.from_numpy(np.ascontiguousarray(frames[::stride])).to(dev)
    return torch.cat([tracker_features(trk, x[i:i + batch]) for i in range(0, len(x), batch)])


# ---------------------------------------------------------------- phase 3


def nms_problem(Bn, N, seed, groups=0):
    """Clustered boxes (suppression happens), scores on a coarse grid (exact
    ties), duplicate pairs, ~15% invalid slots and a padded invalid tail of
    N // 10 slots; with ``groups``, group ids in 1..groups (-1 on the tail).
    Shared with tests/test_torch_kernels_cuda.py."""
    rng = np.random.default_rng(seed)
    ctr = make_rois(Bn, seed, r=12)
    boxes = ctr[np.arange(Bn)[:, None], rng.integers(0, 12, (Bn, N))]
    boxes = (boxes + rng.normal(0, 6, (Bn, N, 4))).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]  # duplicates
    scores = (rng.integers(0, 20, (Bn, N)) / 20.0).astype(np.float32)  # ties
    valid = rng.uniform(size=(Bn, N)) > 0.15
    valid[:, N - N // 10:] = False
    out = [boxes, scores, valid]
    if groups:
        grp = rng.integers(1, groups + 1, (Bn, N)).astype(np.int32)
        grp[:, N - N // 10:] = -1
        out.append(grp)
    return out


def _precedes(scores, valid):
    """(B, i, j): slot j comes before slot i in the greedy visit order."""
    ms = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device)
    si, sj = ms[:, :, None], ms[:, None, :]
    return (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None])[None])


def fixpoint_iou_count(scores, valid, groups=None) -> int:
    """IoUs the Jacobi fixpoint needs on this data: one per valid slot i and
    valid slot j of its group that precedes it (the <= N steps of word ANDs
    on the adjacency bitmasks are not counted)."""
    pair = _precedes(scores, valid) & valid[:, :, None] & valid[:, None, :]
    if groups is not None:
        pair &= groups[:, :, None] == groups[:, None, :]
    return int(pair.sum())


def greedy_iou_count(boxes, scores, valid, thresh, chunk=128) -> int:
    """IoUs the sorted greedy walk needs on this data: for each kept box i,
    one per later valid box not yet suppressed when step i runs."""
    from vdetlib_tpu_torch.geometry.boxes import pairwise_iou
    from vdetlib_tpu_torch.kernels.nms_sorted import nms_sorted_greedy, visit_order

    total = 0
    for c in range(0, boxes.shape[0], chunk):
        b, s, v = boxes[c:c + chunk], scores[c:c + chunk], valid[c:c + chunk]
        order = visit_order(s, v)
        sb = torch.gather(b, 1, order[..., None].expand(b.shape))
        sv = torch.gather(v, 1, order)
        kept = torch.gather(nms_sorted_greedy(b, s, v, thresh), 1, order)
        n = sb.shape[1]
        idx = torch.arange(n, device=b.device)
        later = idx[None, :] > idx[:, None]  # (i, j): j after i
        sup = (pairwise_iou(sb, sb) > thresh) & kept[:, :, None] & later[None]
        first = torch.where(sup.any(1), sup.int().argmax(1), n)  # (B, j) first suppressor
        need = kept[:, :, None] & sv[:, None, :] & later[None] & (idx[None, :, None] <= first[:, None, :])
        total += int(need.sum())
    return total


def flow_case(dev, times):
    """Kernel A against its plain version on the quarter-res gray pairs of a
    256-frame video (the first P pairs), at the pair counts its paths launch
    and at 255: box shifts within mean < 0.05, max < 0.5 full-res px at
    every P; timed by CUDA events at every P, the plain version at 255."""
    from vdetlib_tpu_torch.kernels import flow as tflow
    from vdetlib_tpu_torch.kernels import flow_level as kl

    sv = synth(256, seed=0)
    frames = torch.from_numpy(sv.frames).to(dev)
    gray = tflow._avg_pool2(tflow._avg_pool2(tflow.to_gray(frames))).to(torch.bfloat16)
    scale = tflow.flow_coord_scale("fastest")
    search, radius = 5, 3  # flow_level's defaults, as the "fastest" preset calls it
    # operations per pixel and shift: the squared difference (2), the
    # separable 7x7 box sum (2 x 6 adds), the division by the area (1) and
    # the online soft-argmin (min, 2 sub, 2 mul, 2 exp, den: mul + add, fx
    # and fy: 2 mul + add each = 15)
    per_shift = 2 + 2 * (2 * radius) + 1 + 15
    ms_by_p, worst = {}, 0.0
    for P in FLOW_PAIRS:
        i1, i2 = gray[:P].contiguous(), gray[1:P + 1].contiguous()
        got = kl.flow_level(i1, i2)
        want = kl._flow_level(i1, i2)
        torch.cuda.synchronize()
        boxes = torch.from_numpy(sv.gt_boxes[:, :P].transpose(1, 0, 2).copy()).to(dev)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
        d = (tflow.mean_flow_in_boxes(got, boxes * scale, valid)
             - tflow.mean_flow_in_boxes(want, boxes * scale, valid)).abs() / scale  # full-res px
        err, mean = float(d.max()), float(d.mean())
        field_err = float((got - want).abs().max())
        ms = cuda_ms(lambda: kl.flow_level(i1, i2), iters=20)
        _, Hq, Wq = i1.shape
        b_ms, b_by = bound(i1.numel() * 2 * 2 + got.numel() * 4,
                           P * Hq * Wq * (2 * search + 1) ** 2 * per_shift)
        log(f"kernel flow_level P={P} {tuple(i1.shape)} bf16: {ms:.4f} ms (bound {b_ms:.6f} "
            f"by {b_by}); box-shift err mean {mean:.6f} max {err:.6f} px (tolerance mean "
            f"< 0.05, max < 0.5); field max |diff| {field_err:.6f} cells")
        assert math.isfinite(err) and mean < 0.05 and err < 0.5, f"flow kernel disagrees at P={P}"
        ms_by_p[P] = ms
        worst = max(worst, err)
    plain_ms = cuda_ms(lambda: kl._flow_level(i1, i2), iters=5)
    times.append(f"flow_level kernel {ms:.4f} plain {plain_ms:.4f} bound {b_ms:.4f} "
                 f"(P={P}; by P {ms_by_p})")
    return dict(name="flow_level", route="cuda", source="vdetlib_tpu_torch/csrc/flow_level.cu",
                replaces="vdetlib_tpu/kernels/flow_pallas.py:104", max_abs_err=worst, ms=ms,
                ms_by_p=ms_by_p, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def phase_kernels(dev):
    """Kernels vs plain versions at their paths' shapes → kernel records."""
    from vdetlib_tpu_torch.kernels import nms_batched as kc
    from vdetlib_tpu_torch.kernels import nms_grouped as kb
    from vdetlib_tpu_torch.kernels import nms_sorted as kd

    times = []
    records = {"flow_level": flow_case(dev, times)}

    def nms_case(name, kernel, plain, args, replaces, iou_count, iters, plain_iters):
        """``args`` = boxes, scores, valid (, groups); keep sets must be identical."""
        keep = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        n_diff = int((keep != ref).sum())
        Bn, N = args[1].shape
        n_valid = int(args[2].sum())
        log(f"kernel {name} ({Bn}, {N}): {n_diff} slots differ from the plain version "
            f"(kept {int(keep.sum())} of {n_valid} valid; tolerance: identical)")
        assert n_diff == 0, f"{name} kernel disagrees"
        assert 0 < int(keep.sum()) < n_valid, f"{name}: the problem suppresses nothing"
        ms = cuda_ms(lambda: kernel(*args), iters=iters)
        plain_ms = cuda_ms(lambda: plain(*args), iters=plain_iters, warmup=1)
        n_bytes = sum(a.numel() * a.element_size() for a in args) + keep.numel()
        b_ms, b_by = bound(n_bytes, AREA_OPS * Bn * N + IOU_OPS * iou_count)
        times.append(f"{name} kernel {ms:.4f} plain {plain_ms:.4f} bound {b_ms:.6f} "
                     f"({iou_count} IoUs)")
        records[name] = dict(
            name=name, route="cuda", source=f"vdetlib_tpu_torch/csrc/{name}.cu",
            replaces=replaces, max_abs_err=float(n_diff), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None)

    th = 0.3
    # kernel B: the MGP dedup problem, 256 frames x 192 slots (3 x 64 budget)
    args = [torch.from_numpy(a).to(dev) for a in nms_problem(256, 192, seed=1, groups=30)]
    nms_case("nms_grouped", lambda b, s, v, g: kb.nms_grouped_kernel(b, s, v, g, th),
             lambda b, s, v, g: kb.nms_unsorted_fixpoint(b, s, v, th, groups=g), args,
             "vdetlib_tpu/kernels/nms_pallas.py:261", fixpoint_iou_count(*args[1:]),
             iters=50, plain_iters=10)
    # kernel C: the stream's per-frame per-class NMS, 32 frames x 30 classes x 64
    args = [torch.from_numpy(a).to(dev) for a in nms_problem(32 * 30, 64, seed=2)]
    nms_case("nms_batched", lambda *a: kc.nms_batched_kernel(*a, th),
             lambda *a: kb.nms_unsorted_fixpoint(*a, th), args,
             "vdetlib_tpu/kernels/nms_pallas.py:186", fixpoint_iou_count(*args[1:]),
             iters=50, plain_iters=10)
    # kernel D: the frame-NMS tool's default budget, 64 frames x 30 classes x 512
    args = [torch.from_numpy(a).to(dev) for a in nms_problem(NMS_FRAMES * 30, 512, seed=3)]
    nms_case("nms_sorted", lambda *a: kd.nms_sorted_kernel(*a, th),
             lambda *a: kd.nms_sorted_greedy(*a, th), args,
             "vdetlib_tpu/kernels/nms_pallas.py:354", greedy_iou_count(*args, th),
             iters=20, plain_iters=2)
    records["resize_normalize"] = resize_case(dev, times)
    records["track_scan"] = track_scan_case(dev, times)
    log("times (ms/call, CUDA events; bound from the H100's published peaks): "
        + "; ".join(times))
    return records


def resize_case(dev, times):
    """Kernel E against its plain version: the staged detector's 96 native
    360×480 frames to 240×320, and the pyramid's 240×320 frames to 176×240
    and 304×400 (abs <= 1e-3); timed at the path's call, a batch of 8."""
    import torch.nn.functional as F

    from vdetlib_tpu_torch.kernels import preprocess as ke

    native = torch.from_numpy(staged_video(NATIVE_HW).frames).to(dev)
    net = torch.from_numpy(synth(STAGED_T, seed=21).frames).to(dev)
    err = 0.0
    for frames, hw in ((native, (H, W)), (net, PYRAMID_HW[0]), (net, PYRAMID_HW[1])):
        got = ke.fused_resize_normalize_kernel(frames, hw)
        want = ke.fused_resize_normalize(frames, hw)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        log(f"kernel resize_normalize {tuple(frames.shape)} -> {hw}: max |diff| {e:.3e} "
            f"(tolerance 1e-3)")
        assert got.shape == want.shape and math.isfinite(e) and e <= 1e-3, \
            "resize kernel disagrees"
        err = max(err, e)
    batch = native[:DETECT_B]
    mean = torch.tensor(ke.PIXEL_MEAN, device=dev)

    def library():  # the same half-pixel bilinear resize, then the mean
        x = F.interpolate(batch.permute(0, 3, 1, 2).float(), size=(H, W), mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1) - mean

    lib_err = float((library() - ke.fused_resize_normalize(batch, (H, W))).abs().max())
    ms = cuda_ms(lambda: ke.fused_resize_normalize_kernel(batch, (H, W)), iters=50)
    plain_ms = cuda_ms(lambda: ke.fused_resize_normalize(batch, (H, W)), iters=20)
    lib_ms = cuda_ms(library, iters=20)
    n_out = batch.shape[0] * H * W * 3
    # per output value: two taps per source column (2 mul + add, twice), the
    # column blend (2 mul + add), the mean and the scale (2)
    b_ms, b_by = bound(batch.numel() + n_out * 4, 11 * n_out)
    times.append(f"resize_normalize kernel {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} "
                 f"bound {b_ms:.6f} ({tuple(batch.shape)} -> {(H, W)}; library vs plain "
                 f"max |diff| {lib_err:.2e})")
    return dict(name="resize_normalize", route="cuda",
                source="vdetlib_tpu_torch/csrc/resize_normalize.cu",
                replaces="vdetlib_tpu/kernels/preprocess.py:60", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def scan_ops(Q, P, C):
    """float32 operations of one lane's scan step, from the plain version:
    the pooling's two taps per row and column (9 per window value), the
    bins' sums of squares (2 per value), the template products (2 per term),
    the norm windows (P² adds per offset) and the softmax expectation (~12
    per offset)."""
    R = Q - P + 1
    return 9 * Q * Q * C + 2 * Q * Q * C + 2 * R * R * P * P * C + R * R * (P * P + 12)


def window_taps(lo, hi, size, Q, stride):
    """Feature rows (or columns) that the bilinear taps of a Q-bin window
    over [lo, hi) pixels read (nn/heads.py::_bilinear_weights, float64)."""
    start, end = lo / stride, hi / stride
    pos = np.clip(start + (np.arange(Q) + 0.5) * (end - start) / Q - 0.5, 0, size - 1)
    g = np.floor(pos).astype(int)
    return np.unique(np.concatenate([g, np.minimum(g + 1, size - 1)]))


def scan_work(feats, anchor_ts, want, cfg):
    """What the scan needs on this data: (feature positions read, lane-steps).

    Only a lane-step that tracks (alive before it, not at its anchor) reads
    features: the taps of its search window, around the box the step before
    left (the plain run's outputs ``want``, indexed by frame). A position
    read by several lanes at one frame counts once."""
    fb, _, fa, bb, _, ba = want
    T, h, w, _ = feats.shape
    Q = cfg.search_pool
    touched = np.zeros((T, h, w), bool)
    n_live = 0
    for step, boxes, alive in ((-1, fb, fa), (1, bb, ba)):
        for t in range(T):
            prev = t + step
            if not 0 <= prev < T:
                continue
            for box in boxes[prev][alive[prev] & (anchor_ts != t)]:
                cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
                hw_, hh_ = (box[2] - box[0]) * cfg.search_factor / 2, \
                    (box[3] - box[1]) * cfg.search_factor / 2
                rows = window_taps(cy - hh_, cy + hh_, h, Q, cfg.stride)
                cols = window_taps(cx - hw_, cx + hw_, w, Q, cfg.stride)
                touched[t][np.ix_(rows, cols)] = True
                n_live += 1
    return int(touched.sum()), n_live


def ptxas_usage(log: str, entry: str):
    """(registers, spill bytes) that ptxas reported for the entry function
    whose mangled name contains ``entry`` (None where the log lacks it)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            regs = spill = None
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    spill = int(nxt.split("bytes spill stores")[0].split(",")[-1])
                if "Used" in nxt and "registers" in nxt:
                    regs = int(nxt.split("Used")[1].split("registers")[0])
            return regs, spill
    return None, None


def track_scan_case(dev, times):
    """Kernel F against its plain version on the staged tracker's features
    (the base tracker on every 2nd frame of the 360×480 video: 48 × 90×120×96
    bf16): one-step clips (T = 2, anchors at frame 0 and at frame 1; boxes
    <= 1e-3 px, peaks <= 1e-4, alive equal) in bf16 and float32, a 16-step
    rollout (alive equal, live boxes < 0.1 px), the same at two other search
    windows (Q = 12 and 20), and the full 48-step round (printed, not
    gated); timed at the round's shape, A = 8, in ms a round and µs a step,
    beside the compiled-in instantiation's registers (ptxas) and its
    dynamic shared memory."""
    from vdetlib_tpu_torch.kernels import build
    from vdetlib_tpu_torch.kernels import track_scan as kf
    from vdetlib_tpu_torch.nn.tracker_net import extract_template

    _, trk, cfg = base_models(dev)
    sv = staged_video(NATIVE_HW)
    with torch.no_grad():
        feats = staged_features(trk, sv.frames, dev)
    Ts = feats.shape[0]
    rng = np.random.default_rng(7)
    K = sv.gt_boxes.shape[0]

    def anchors(t_full, n):
        k = rng.integers(0, K, n)
        return (sv.gt_boxes[k, t_full] + rng.normal(0, 3, (n, 4))).astype(np.float32)

    def run(f, ats, boxes, c):
        ats = torch.as_tensor(ats, device=dev)
        boxes = torch.as_tensor(boxes, device=dev)
        tpl = extract_template(f[ats], boxes, c)
        args = (f, ats, boxes, tpl, c, 0.5)
        got = kf.track_scan_kernel(*args)
        want = kf.track_scan_plain(*args)
        torch.cuda.synchronize()
        return [g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], args

    def one_steps(c, dtypes, every):
        box_e = peak_e = 0.0
        n = 0
        for dtype in dtypes:
            for j in range(0, Ts - 1, every):  # one-step clips over the video
                ats = np.repeat([0, 1], 32)  # 32 anchors at each of the clip's two frames
                boxes = np.concatenate([anchors(2 * j, 32), anchors(2 * j + 2, 32)])
                got, want, _ = run(feats[j:j + 2].to(dtype), ats, boxes, c)
                for g, w in zip(got[2::3], want[2::3]):
                    assert np.array_equal(g, w), "track_scan kernel: one-step alive bits differ"
                box_e = max(box_e, *(float(np.abs(g - w).max()) for g, w in
                                     zip(got[0::3], want[0::3])))
                peak_e = max(peak_e, *(float(np.abs(g - w).max()) for g, w in
                                       zip(got[1::3], want[1::3])))
                n += 64
        return box_e, peak_e, n

    def rollout(T_r, c):
        ats = rng.integers(0, T_r, A)
        boxes = np.stack([anchors(2 * int(t), 1)[0] for t in ats])
        got, want, args = run(feats[:T_r], ats, boxes, c)
        alive_eq = float(np.mean([np.mean(g == w) for g, w in zip(got[2::3], want[2::3])]))
        live = [w for w in want[2::3]]
        box_err = max(float(np.abs(g - w)[m].max(initial=0.0))
                      for g, w, m in zip(got[0::3], want[0::3], live))
        conf_err = max(float(np.abs(g - w)[m].max(initial=0.0))
                       for g, w, m in zip(got[1::3], want[1::3], live))
        return alive_eq, box_err, conf_err, args, want

    step_box, step_peak, n_steps = one_steps(cfg, (torch.bfloat16, torch.float32), 12)
    log(f"kernel track_scan one step ({n_steps} lanes in T=2 clips, bf16 and float32 "
        f"features): max box diff {step_box:.3e} px, max peak diff {step_peak:.3e} "
        f"(tolerance 1e-3 px, 1e-4; alive equal)")
    assert step_box <= 1e-3 and step_peak <= 1e-4, "track_scan kernel disagrees on one step"
    alive_eq, box_err, conf_err, _, _ = rollout(16, cfg)
    log(f"kernel track_scan 16-step rollout (A={A}): alive agreement {alive_eq:.4f}, live box "
        f"diff {box_err:.3e} px, live conf diff {conf_err:.3e} (tolerance: alive equal, "
        f"< 0.1 px, < 5e-3)")
    assert alive_eq == 1.0 and box_err < 0.1 and conf_err < 5e-3, \
        "track_scan kernel departs within 16 steps"
    for factor in (1.5, 2.5):  # Q and P are the kernel's arguments
        c = dataclasses.replace(cfg, search_factor=factor)
        b_e, p_e, n = one_steps(c, (torch.bfloat16,), 24)
        alive_eq, box_err, conf_err, _, _ = rollout(16, c)
        log(f"kernel track_scan at Q={c.search_pool}, P={c.template_pool}: one step ({n} lanes) "
            f"box diff {b_e:.3e} px, peak diff {p_e:.3e}; 16-step rollout alive agreement "
            f"{alive_eq:.4f}, live box diff {box_err:.3e} px, live conf diff {conf_err:.3e} "
            f"(tolerances as above)")
        assert b_e <= 1e-3 and p_e <= 1e-4 and alive_eq == 1.0 and box_err < 0.1 \
            and conf_err < 5e-3, f"track_scan kernel disagrees at Q={c.search_pool}"
    alive_eq, box_err, conf_err, args, want = rollout(Ts, cfg)
    log(f"kernel track_scan {Ts}-step round (A={A}, not gated): alive agreement {alive_eq:.4f}, "
        f"live box diff {box_err:.3e} px, live conf diff {conf_err:.3e}")
    ms = cuda_ms(lambda: kf.track_scan_kernel(*args), iters=10)
    plain_ms = cuda_ms(lambda: kf.track_scan_plain(*args), iters=2, warmup=1)
    f, ats, _, tpl, _, _ = args
    Q, P, Cf = cfg.search_pool, cfg.template_pool, f.shape[-1]
    regs, spill = ptxas_usage(build.build_log("track_scan"),
                              f"track_scan_kernelI13__nv_bfloat16Lb1ELi{Q}ELi{P}ELi{Cf}E")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_cta = kf.cluster_ctas(A, sms)
    log(f"kernel track_scan round: {ms:.4f} ms = {ms * 1e3 / Ts:.2f} us a step; {n_cta} blocks a "
        f"lane ({2 * A * n_cta} of {sms} SMs), "
        f"{kf._smem_bytes(Q, P, Cf, True, kf.launch_parts(Q, P, Cf, True))} bytes of dynamic "
        f"shared memory a block; ptxas: {regs} registers, {spill} bytes spilled (bf16, Q={Q}, "
        f"P={P}, C={Cf} compiled in)")
    n_pos, n_live = scan_work(f, ats.cpu().numpy(), want, cfg)
    n_bytes = (n_pos * Cf * f.element_size() + tpl.numel() * 4 + A * 4 * 4
               + 2 * Ts * A * (4 * 4 + 4 + 1))
    b_ms, b_by = bound(n_bytes, n_live * scan_ops(Q, P, Cf))
    times.append(f"track_scan kernel {ms:.4f} plain {plain_ms:.4f} bound {b_ms:.6f} "
                 f"({Ts} steps x {2 * A} lanes over {tuple(f.shape)}: {n_live} lane-steps "
                 f"track, reading {n_pos} of {Ts * f.shape[1] * f.shape[2]} feature positions, "
                 f"{n_bytes / 1e6:.2f} MB)")
    return dict(name="track_scan", route="cuda", source="vdetlib_tpu_torch/csrc/track_scan.cu",
                replaces="vdetlib_tpu/kernels/track_pallas.py:230",
                max_abs_err=max(step_box, step_peak), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------- phase 4


def tiny_models(dev, seed=0):
    """The tiny preset (C=4) and the tracker in float32, seeded, on ``dev``."""
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset("tiny", num_classes=4, dtype=torch.float32),
                        torch.Generator().manual_seed(seed), device=dev)
    det.head.dtype = det.head.fc0.dtype = torch.float32
    with torch.no_grad():
        det.head.bbox.weight.mul_(0.1)  # a trained regressor's delta scale
    trk_cfg = TrackerConfig(dtype=torch.float32)
    trk = init_tracker(trk_cfg, torch.Generator().manual_seed(seed + 1), device=dev)
    return det, trk, trk_cfg


def tiny_pipeline(dev, seed=0):
    """The tiny fused pipeline at 96×128 in float32 (detector and tracker) on ``dev``."""
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig, make_fused_pipeline

    det, trk, trk_cfg = tiny_models(dev, seed)
    cfg = FusedConfig(image_hw=(96, 128), detect_batch=8, feat_batch=8, anchors_per_round=4,
                      max_tracks=8, max_paths=16, det_budget=24, out_budget=24,
                      score_thresh=0.2, anchor_thresh=0.26)
    return make_fused_pipeline(det, trk, trk_cfg, cfg)


def tiny_inputs(seed=5, T=16):
    sv = synth(T, seed, h=96, w=128)
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


def tiny_stream(dev, frames, rois):
    """The tiny float32 stream (chunk 8, 16 proposals, 6 slots) on ``dev``."""
    from vdetlib_tpu_torch.video.stream import StreamOptions, stream_video

    det, trk, trk_cfg = tiny_models(dev)
    opts = StreamOptions(chunk=8, max_rois=16, num_classes=4, track_slots=6, seed_thresh=0.26,
                         max_paths=20)
    chunks = (frames[s:s + 8] for s in range(0, len(frames), 8))
    return stream_video(det, trk, trk_cfg, chunks, rois, opts)


def compare_streams(got, want):
    """Stream results within the port's bounds; returns the worst float error."""
    assert got["num_frames"] == want["num_frames"]
    assert np.array_equal(got["keep"], want["keep"]), "stream keep bits differ"
    m = want["keep"].any(1)
    errs = [np.abs(got["boxes"] - want["boxes"])[m].max(initial=0.0)]
    errs += [np.abs(got[k] - want[k]).max(initial=0.0) for k in ("scores", "seq_scores")]
    assert errs[0] <= 0.5 and max(errs[1:]) <= 0.01, f"stream floats differ by {errs}"
    assert (got["path_ids"] != want["path_ids"]).mean() < 0.01, "stream path ids differ"
    assert set(got["tracks"]) == set(want["tracks"]), "stream track ids differ"
    track_errs = {}
    for tid, wseg in want["tracks"].items():
        gseg = got["tracks"][tid]
        assert [t for t, _, _ in gseg] == [t for t, _, _ in wseg], f"track {tid} frames differ"
        track_errs[tid] = max(float(np.abs(np.asarray(gb) - np.asarray(wb)).max())
                              for (_, gb, _), (_, wb, _) in zip(gseg, wseg))
    log(f"stream track box errors (px, per track over {want['num_frames']} frames): "
        f"{ {k: round(v, 6) for k, v in track_errs.items()} }")
    assert max(track_errs.values(), default=0.0) <= 0.5, "stream track boxes differ"
    return float(max(errs + list(track_errs.values())))


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

    # 1.5 chunks of 8: a carried chunk, a partial one and a backtrack. Not
    # longer: every stage agrees to its last bits (class probabilities 6e-7,
    # tracker features 1.2e-6 relative, keep bits and seeds equal), but the
    # tracker rollout amplifies the first last-bit difference ~2x per frame
    # where it flips a rounding of the bf16 search-window pooling. On a
    # 20-frame input, card vs CPU: <= 0.0034 px up to frame 11, 0.89 px at
    # frame 17 (0.038 px with float32 pooling), as a 2^-22 change of the
    # features does on the CPU alone (scripts/torch_stream_divergence.py)
    frames, rois, _ = tiny_inputs(seed=8, T=12)
    want = tiny_stream("cpu", frames, rois)
    got = tiny_stream(dev, frames, rois)
    worst = compare_streams(got, want)
    assert len(want["tracks"]) >= 1 and (want["path_ids"] >= 0).any()
    log(f"reference: tiny f32 stream on {dev} == CPU within bounds (worst float diff "
        f"{worst:.6f}, {len(want['tracks'])} tracks, {int(want['keep'].sum())} kept)")


# ---------------------------------------------------------------- phase 5


def base_models(dev, seed=0):
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset("base", num_classes=C),
                        torch.Generator().manual_seed(seed), device=dev)
    trk_cfg = TrackerConfig()
    trk = init_tracker(trk_cfg, torch.Generator().manual_seed(seed + 1), device=dev)
    return det, trk, trk_cfg


def base_pipeline(dev, seed=0):
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig, make_fused_pipeline

    det, trk, trk_cfg = base_models(dev, seed)
    cfg = FusedConfig(image_hw=(H, W), detect_batch=B, feat_batch=B, anchors_per_round=A,
                      max_tracks=A, max_paths=32)
    return make_fused_pipeline(det, trk, trk_cfg, cfg)


def slice_inputs(T, seed):
    from vdetlib_tpu_torch.pipeline.fused import pad_snippet

    sv = synth(T, seed)
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


def zero_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels, path_name, need):
    counts = {name: fn.launches for name, fn in kernels.items()}
    log(f"{path_name}: kernel launches {counts}")
    for name in need:
        assert counts[name] > 0, f"kernel {name} never launched on the {path_name} path"
    return counts


def phase_slice(dev, kernels, profile_dir=None):
    """The base-width fused slice over the synthetic videos; ``kernels`` maps
    each kernel's name to its wrapper, whose launch counter is read around
    the run."""
    from vdetlib_tpu_torch.pipeline.fused import fused_to_protos, make_fused_pipeline

    videos = [slice_inputs(T, seed) for seed, T in enumerate(VIDEO_LENGTHS)]
    pipe = base_pipeline(dev)
    thresh = calibrated_anchor_thresh(pipe, dev, videos)
    if thresh is not None:
        pipe = make_fused_pipeline(pipe.det_model, pipe.trk_model, pipe.trk_cfg,
                                   dataclasses.replace(pipe.cfg, anchor_thresh=thresh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
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
    launches = read_counts(kernels, "fused slice", ("flow_level", "nms_grouped", "track_scan"))
    peak = torch.cuda.max_memory_allocated()
    steady = sum(VIDEO_LENGTHS[1:]) / sum(times[1:])
    log(f"slice: {n_frames} frames in {sum(times):.3f} s = {n_frames / sum(times):.2f} frames/s "
        f"(after the first video: {steady:.2f} frames/s); peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if profile_dir:
        profile_one(lambda: pipe(*[torch.from_numpy(a).to(dev) for a in videos[-1][:2]],
                                 videos[-1][2], torch.from_numpy(videos[-1][3]).to(dev)),
                    profile_dir, "profile.txt", "fused.")
    return launches, n_frames / sum(times), steady, peak


def profile_one(run, out_dir, fname, prefix):
    """One traced run: per-stage and per-kernel device time into ``out_dir``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            run()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    with open(os.path.join(out_dir, fname), "w") as f:
        f.write(table)
    # host-side spans only: device time = the kernels launched inside the span
    # by torch ops (a kernel launched through ctypes is not attributed to
    # its span, so the hand-written kernels are listed on their own)
    events = prof.key_averages()
    spans = [e for e in events if e.key.startswith(prefix) and e.cpu_time_total > 0]
    for e in sorted(spans, key=lambda e: e.key):
        log(f"profile {e.key}: cpu {e.cpu_time_total / 1e3:.3f} ms, "
            f"device {e.device_time_total / 1e3:.3f} ms")
    from vdetlib_tpu_torch.kernels.build import KERNELS

    for e in events:
        name = next((n for n in KERNELS if f"{n}_kernel" in e.key), None)
        if name and e.device_time_total > 0:
            log(f"profile kernel {name}: {e.count} launches, device "
                f"{e.device_time_total / 1e3:.3f} ms")


# ---------------------------------------------------------------- phase 6


def calibrated_seed_thresh(det, dev, videos, seed_thresh, chunk):
    """Random weights put class scores near 1/C, below the stream's
    ``seed_thresh``: lower it to the smallest over the videos of the 95th
    percentile of their proposals' best class score, so that every video
    seeds tracks."""
    from vdetlib_tpu_torch.video.detect import _detect_step

    qs, tops = [], []
    for frames, rois in videos:
        best = []
        for s in range(0, len(frames), chunk):
            with torch.no_grad():
                probs, _ = _detect_step(det, torch.from_numpy(frames[s:s + chunk]).to(dev),
                                        torch.from_numpy(rois[s:s + chunk]).to(dev), True)
            best.append(probs[..., 1:].amax(-1).reshape(-1).float())
        best = torch.cat(best)
        tops.append(float(best.max()))
        qs.append(float(torch.quantile(best, 0.95)))
    if min(tops) >= seed_thresh:
        return seed_thresh
    thresh = min(qs)
    log(f"no proposal of some video reaches seed_thresh={seed_thresh} with random weights "
        f"(per-video max {[round(t, 4) for t in tops]}); seed_thresh lowered to {thresh:.6f}")
    return thresh


def phase_stream(dev, kernels, models, opts, profile_dir=None):
    """The stream engine at ``opts`` over two synthetic videos."""
    from vdetlib_tpu_torch.video.stream import stream_to_protos, stream_video

    det, trk, trk_cfg = models
    videos = []
    for i, T in enumerate(STREAM_LENGTHS):
        sv = synth(T, seed=10 + i)
        videos.append((sv.frames, make_rois(T, seed=10 + i, r=opts.max_rois), sv.frame_ids))
    thresh = calibrated_seed_thresh(det, dev, [v[:2] for v in videos], opts.seed_thresh,
                                    opts.chunk)
    opts = dataclasses.replace(opts, seed_thresh=thresh)

    def chunks(frames, marks):
        for s in range(0, len(frames), opts.chunk):
            marks.append(time.perf_counter())
            yield frames[s:s + opts.chunk]
        marks.append(time.perf_counter())  # the last chunk is done

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    walls, chunk_ms, n_frames, first_chunk = [], [], 0, None
    for i, (frames, rois, fids) in enumerate(videos):
        marks = []
        t0 = time.perf_counter()
        res = stream_video(det, trk, trk_cfg, chunks(frames, marks), rois, opts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        walls.append(dt)
        n_frames += len(frames)
        per_chunk = np.diff(marks) * 1e3
        if first_chunk is None:
            first_chunk = per_chunk[0] / 1e3
        chunk_ms.extend(per_chunk[1:len(frames) // opts.chunk])  # full chunks after the first
        det_proto, tubelets, track_proto = stream_to_protos(res, fids, f"stream{i:03d}")
        for k in ("boxes", "scores", "seq_scores"):
            assert np.isfinite(res[k]).all(), f"non-finite stream {k}"
        assert res["boxes"].shape == (len(frames), 3 * opts.max_rois, 4)
        assert len(res["tracks"]) >= 1, "no tracks seeded"
        assert any(s == 0.0 for seg in res["tracks"].values() for _, _, s in seg), \
            "no backtracked track entries"
        assert (res["path_ids"] >= 0).any(), "no seq-NMS paths"
        assert len(det_proto["detections"]) > 0 and len(tubelets["tracks"]) > 0 \
            and len(track_proto["tracks"]) > 0, "empty stream protos"
        log(f"stream video {i}: T={len(frames)} in {len(per_chunk)} chunks, {dt * 1e3:.1f} ms "
            f"(chunks {[round(float(x), 1) for x in per_chunk]} ms; seq-NMS and protos "
            f"{(t0 + dt - marks[-1]) * 1e3:.1f} ms), {len(res['tracks'])} tracks, "
            f"{int(res['keep'].sum())} kept, proto dets {len(det_proto['detections'])}, "
            f"tubelets {len(tubelets['tracks'])}, online tracks {len(track_proto['tracks'])}")
    launches = read_counts(kernels, "stream", ("flow_level", "nms_grouped", "nms_batched"))
    peak = torch.cuda.max_memory_allocated()
    fps = n_frames / sum(walls)
    steady = (n_frames - opts.chunk) / (sum(walls) - first_chunk)
    med = float(np.median(chunk_ms))
    log(f"stream: {n_frames} frames in {sum(walls):.3f} s = {fps:.2f} frames/s (after the "
        f"first chunk: {steady:.2f} frames/s); full chunk of {opts.chunk} frames: median "
        f"{med:.1f} ms ({opts.chunk / med * 1e3:.2f} frames/s); peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if profile_dir:
        frames, rois, _ = videos[-1]
        profile_one(lambda: stream_video(det, trk, trk_cfg, chunks(frames, []), rois, opts),
                    profile_dir, "profile_stream.txt", "stream.")
    return launches, fps, steady, med, peak


# ---------------------------------------------------------------- phase 7


def frame_nms_protos(T, max_dets, seed, classes=30):
    """vid/det protos in memory from ``det_proto_from_gt``: 12 objects of
    ``classes`` classes, each with max_dets // 16 jittered detections, and
    the rest of ``max_dets`` as distractors, so a frame holds at most
    ``max_dets`` (fewer where an object drops out); scores snapped to a 1/20
    grid for exact ties, and every 7th detection carries a second class."""
    from vdetlib_tpu_torch.data.synth import (SynthConfig, det_proto_from_gt, make_video,
                                              vid_proto_in_memory)

    per_obj = max_dets // 16
    sv = make_video(SynthConfig(num_frames=T, height=H, width=W, num_objects=12,
                                num_classes=classes + 1, jitter=1.0, seed=seed))
    det = det_proto_from_gt(sv, dets_per_object=per_obj,
                            distractors_per_frame=max_dets - 12 * per_obj, drop_rate=0.2)
    for i, d in enumerate(det["detections"]):
        s = d["scores"][0]
        s["score"] = round(s["score"] * 20) / 20
        if i % 7 == 0:
            c = s["class_index"] % classes + 1
            d["scores"].append({"class": str(c), "class_index": c, "score": 0.5})
    return vid_proto_in_memory(sv), det


def phase_frame_nms(dev, kernels):
    """The frame-NMS tool's device backend against its host backend."""
    from vdetlib_tpu_torch.video.frame_nms import frame_nms

    zero_counts(kernels)
    for max_boxes, kernel in ((512, "nms_sorted"), (128, "nms_batched")):
        vid, det = frame_nms_protos(NMS_FRAMES, max_boxes, seed=max_boxes)
        t0 = time.perf_counter()
        want = frame_nms(vid, det, thresh=0.3, backend="host")
        t1 = time.perf_counter()
        got = frame_nms(vid, det, thresh=0.3, backend="pallas", max_boxes=max_boxes, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert 0 < len(want["detections"]) < len(det["detections"])
        assert got == want, f"frame_nms pallas at max_boxes {max_boxes} differs from host"
        log(f"frame_nms {NMS_FRAMES} frames x 30 classes, <= {max_boxes} dets/frame "
            f"({len(det['detections'])} in, {len(want['detections'])} out): pallas "
            f"({kernel}) == host; host {(t1 - t0) * 1e3:.1f} ms, pallas {(t2 - t1) * 1e3:.1f} ms "
            f"wall")
    return read_counts(kernels, "frame NMS", ("nms_sorted", "nms_batched"))


# ---------------------------------------------------------------- phase 8


def staged_box_proto(rois, sv):
    """A box_proto of ``rois`` (T, R, 4), one list of proposals per frame."""
    return {"video": sv.video, "boxes": [{"frame": int(fid), "bbox": [float(v) for v in r]}
                                         for fid, rs in zip(sv.frame_ids, rois) for r in rs]}


def check_det_proto(name, det_proto, hw, score_thresh):
    """Finite boxes inside the (H, W) frame, real classes, scores in range."""
    dets = det_proto["detections"]
    assert len(dets) > 0, f"{name}: empty det_proto"
    b = np.array([d["bbox"] for d in dets])
    sc = np.array([d["scores"][0]["score"] for d in dets])
    ci = np.array([d["scores"][0]["class_index"] for d in dets])
    assert np.isfinite(b).all() and np.isfinite(sc).all(), f"{name}: non-finite"
    assert b.min() >= 0 and b[:, 2].max() <= hw[1] + 1e-3 and b[:, 3].max() <= hw[0] + 1e-3, \
        f"{name}: boxes outside the frame"
    assert sc.min() >= score_thresh and sc.max() <= 1.0, f"{name}: scores out of range"
    assert ci.min() >= 1 and ci.max() < C, f"{name}: class indices"
    return sc


def phase_staged(dev, kernels, profile_dir=None):
    """The staged detect → track path with the base models through its entry
    points: ``det_vid`` with ``device_resize`` over the native video,
    ``det_vid`` with the pyramid at (H, W), and ``track_from_det`` at the
    track tool's defaults over the first det_proto (kernels E and F launch).
    The card has no cv2: the frames are handed over in memory."""
    from collections import Counter

    from vdetlib_tpu_torch.data.synth import vid_proto_in_memory
    from vdetlib_tpu_torch.video.detect import DetectOptions, det_vid
    from vdetlib_tpu_torch.video.track import TrackOptions, track_from_det

    det, trk, trk_cfg = base_models(dev)
    sv = staged_video(NATIVE_HW)
    sv_net = synth(STAGED_T, seed=21)
    vid, vid_net = vid_proto_in_memory(sv), vid_proto_in_memory(sv_net)
    boxes = staged_box_proto(
        make_rois(STAGED_T, seed=20, h=NATIVE_HW[0], w=NATIVE_HW[1], r=STAGED_R), sv)
    boxes_net = staged_box_proto(make_rois(STAGED_T, seed=21, r=STAGED_R), sv_net)
    dopts = DetectOptions()  # the detect tool's defaults: batch 8, 128 proposals, 240x320
    assert (dopts.batch_size, dopts.max_rois, tuple(dopts.image_hw)) == (DETECT_B, STAGED_R, (H, W))
    topts = TrackOptions()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    walls = {}
    t0 = time.perf_counter()
    det_proto = det_vid(det, vid, boxes, dataclasses.replace(dopts, device_resize=True),
                        frames_u8=sv.frames)
    torch.cuda.synchronize()
    walls["det_vid (device resize)"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    pyr = det_vid(det, vid_net, boxes_net, dataclasses.replace(dopts, pyramid=PYRAMID),
                  frames_u8=sv_net.frames)
    torch.cuda.synchronize()
    walls["det_vid (pyramid)"] = time.perf_counter() - t1
    scores = check_det_proto("device resize", det_proto, NATIVE_HW, dopts.score_thresh)
    check_det_proto("pyramid", pyr, (H, W), dopts.score_thresh)
    # the pyramid's scores are maxima over its scales, 1.0 among them: each
    # (frame, class) keeps at least the entries of the single scale
    single = det_vid(det, vid_net, boxes_net, dopts, frames_u8=sv_net.frames)
    n_pyr = Counter((d["frame"], d["scores"][0]["class_index"]) for d in pyr["detections"])
    n_one = Counter((d["frame"], d["scores"][0]["class_index"]) for d in single["detections"])
    assert all(n_pyr[k] >= v for k, v in n_one.items()), "pyramid below one scale"

    # random weights put class scores near 1/C: when fewer detections than
    # max_tracks reach anchor_thresh, lower it to the 95th percentile of the
    # entries' scores, as phases 5 and 6 do, so that every round has anchors
    thresh = topts.anchor_thresh
    if (scores >= thresh).sum() < topts.max_tracks:
        thresh = float(np.quantile(scores, 0.95))
        log(f"{int((scores >= topts.anchor_thresh).sum())} detections reach anchor_thresh="
            f"{topts.anchor_thresh} with random weights (max {scores.max():.4f}); "
            f"anchor_thresh lowered to {thresh:.6f}")
    opts = dataclasses.replace(topts, anchor_thresh=thresh)
    t2 = time.perf_counter()
    track = track_from_det(trk, vid, det_proto, trk_cfg, opts, frames_u8=sv.frames)
    torch.cuda.synchronize()
    walls["track_from_det"] = time.perf_counter() - t2
    tracks = track["tracks"]
    assert 1 <= len(tracks) <= opts.max_tracks, "no tracks"
    for tr in tracks:
        assert all(math.isfinite(v) for e in tr for v in e["bbox"] + [e["score"]])
        assert any(e["frame"] == e["anchor"] and e["score"] == 1.0 for e in tr), "anchor lost"
    launches = read_counts(kernels, "staged detect → track", ("resize_normalize", "track_scan"))
    peak = torch.cuda.max_memory_allocated()
    log(f"staged: {STAGED_T} native {NATIVE_HW[0]}x{NATIVE_HW[1]} frames, "
        f"{len(det_proto['detections'])} det_proto entries (pyramid {len(pyr['detections'])}, "
        f"single scale {len(single['detections'])}), {len(tracks)} tracks "
        f"({sum(len(t) for t in tracks)} boxes); wall "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
        + f"; peak device memory {peak / 2**20:.1f} MiB")
    if profile_dir:
        profile_one(lambda: track_from_det(trk, vid, det_proto, trk_cfg, opts,
                                           frames_u8=sv.frames),
                    profile_dir, "profile_staged.txt", "track.")
    return launches


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one fused video, one stream video and the staged "
                         "tracker into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from vdetlib_tpu_torch.kernels import build
    from vdetlib_tpu_torch.kernels.flow_level import flow_level
    from vdetlib_tpu_torch.kernels.nms_batched import nms_batched_kernel
    from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel
    from vdetlib_tpu_torch.kernels.nms_sorted import nms_sorted_kernel
    from vdetlib_tpu_torch.kernels.preprocess import fused_resize_normalize_kernel
    from vdetlib_tpu_torch.kernels.track_scan import track_scan_kernel
    from vdetlib_tpu_torch.video.stream import StreamOptions

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    for name in build.KERNELS:
        build.load(name)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(build.KERNELS)} kernels in parallel, {time.perf_counter() - t0:.2f} s")

    records = phase_kernels(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    kernels = {"flow_level": flow_level, "nms_grouped": nms_grouped_kernel,
               "nms_batched": nms_batched_kernel, "nms_sorted": nms_sorted_kernel,
               "resize_normalize": fused_resize_normalize_kernel,
               "track_scan": track_scan_kernel}
    slice_counts, fps, steady, peak = phase_slice(dev, kernels, args.profile)
    torch.cuda.synchronize()
    log(f"slice throughput on {card}: {fps:.2f} frames/s overall, {steady:.2f} frames/s "
        f"steady; peak memory {peak / 2**20:.1f} MiB")
    stream_counts, sfps, ssteady, chunk_ms, speak = phase_stream(
        dev, kernels, base_models(dev), StreamOptions(), args.profile)
    torch.cuda.synchronize()
    log(f"stream throughput on {card}: {sfps:.2f} frames/s overall, {ssteady:.2f} after the "
        f"first chunk, {chunk_ms:.1f} ms per full chunk; peak memory {speak / 2**20:.1f} MiB")
    nms_counts = phase_frame_nms(dev, kernels)
    torch.cuda.synchronize()
    staged_counts = phase_staged(dev, kernels, args.profile)
    torch.cuda.synchronize()

    own_path = {"flow_level": slice_counts, "nms_grouped": slice_counts,
                "nms_batched": stream_counts, "nms_sorted": nms_counts,
                "resize_normalize": staged_counts, "track_scan": staged_counts}
    for name, rec in records.items():
        rec["launches"] = own_path[name][name]
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
