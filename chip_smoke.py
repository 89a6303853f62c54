#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vdetlib_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each synchronised and each fatal on failure:

1. device: a CUDA device is required (no CPU fallback); TF32 is switched off
   for matmuls and convolutions, as the float32 reference computes;
2. build: every hand-written kernel of ``vdetlib_tpu_torch/csrc`` is
   compiled with nvcc (one process per source, all at once, into
   ``vdetlib_tpu_torch/_build``) and loaded, with the native host NMS
   (``csrc/nms_host.cpp``, g++) among them;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of its path, each timed three ways beside its bound: the
   wall per call (CUDA events around back-to-back calls), the kernel's
   device time per launch (torch.profiler's CUPTI records of the kernels
   named ``<name>_kernel``) and the wrapper's host time per call:
   A, flow level: 32, 63, 95 and 255 pairs of 60×80 bf16 (the stream's
   chunk, the fused slice's buckets, a 256-frame video) and 95 pairs of
   90×120 (the staged MGP over phase 8's 96 native 360×480 frames), and
   its float32 path at search 3 at the "accurate" pyramid's level shapes
   for 240×320 frames (63 and 255 pairs of 240×320, 120×160 and 60×80) and
   95 pairs of 360×480 (the staged MGP's finest level), its bf16 device
   time at P = 255 printed beside PERF.md's; box-shift tolerance mean <
   0.05 px, max < 0.5 px at each; B, grouped NMS: 256
   frames × 192 slots with 30 class groups (the fused dedup), and 32 and
   960 problems of 192 slots with one group (the stream's MGP dedup for
   one class and for a chunk's 32 frames × 30 classes); C, batched NMS:
   the stream's 960 problems (32 frames × 30 classes) of 64 slots; D,
   sorted NMS: 1,920 problems (64 frames × 30 classes) of 512 slots, dense
   and from phase 7's protos (the tool's own, ~17 valid a problem), and of
   2,048 dense slots, timed as the whole call, which must be one kernel on
   the device; its bound counts the valid slots' boxes and scores only.
   The NMS problems hold ties, invalid and padded slots, their keep sets
   must be identical, and the Jacobi steps of B's and C's fixpoints are
   counted with the plain version; E,
   resize + normalize: 96 native 360×480 frames to 240×320 and 240×320
   frames to the pyramid's 176×240 and 304×400, abs <= 1e-3, timed at each
   in batches of 8 beside ``F.interpolate`` + mean; F, tracker scan, on the staged
   tracker's features (48 × 90×120×96 bf16): one-step clips (T = 2, anchors
   at frame 0 and at frame 1, bf16 and float32 features; boxes <= 1e-3 px,
   peaks <= 1e-4, alive equal), a 16-step rollout (alive equal, live boxes
   < 0.1 px), both again at search windows of Q = 12 and 20 bins, and the
   48-step round (printed, not gated; timed in ms a round and µs a step,
   with its registers from the ptxas log and its shared memory); then the
   NMS routes around B's and D's limits against the CPU's plain versions:
   ``nms_grouped`` at 256 frames × 576 slots in 30 groups takes the
   sort-free fixpoint and launches no B (at 192 slots it launches B), and
   ``batched_nms`` over 2 problems of 8,200 slots takes it and launches no
   D; keep sets identical; G, seq-NMS, at the sweep's 30 lanes × 64 slots
   and 100 paths at T = 288 and 480: path ids and suppressions equal the
   plain version's (timed once, on the card), scores within 1e-6
   relative, one G launch a call, the call's device kernels counted, its
   bound from ``utils/flops.py::seq_nms_flops``;
4. reference: the tiny float32 fused pipeline (its tracker scan is kernel F
   on the card) and the tiny float32 stream on the card equal the same runs
   on the CPU (plain kernel versions) within the port's cross-framework
   bounds (bool fields exact, path ids < 1% of slots, boxes 0.5 px, scores
   0.01; stream track segments on the same frames); the tiny pipeline
   again at ``mgp_window`` 4 with 64 detections a frame (a 576-slot
   dedup: no launch of B); the tiny stream also through the host engine at
   ``track_stride`` 2;
5. fused slice: the ``base`` detector (C=31) and the default tracker with
   seeded random weights run ``pad_snippet`` → ``make_fused_pipeline`` →
   ``fused_to_protos`` at 240×320 over three synthetic videos; kernels A, B,
   F and G must launch;
6. stream: the same models run ``stream_video`` → ``stream_to_protos`` at
   the stream tool's defaults (chunk 32, 64 proposals, 16 track slots) over
   videos of 96 and 100 frames (the second ends in a partial chunk of 4);
   kernels A, B and C must launch; the video-end seq-NMS over 192 slots a
   frame takes the plain version (no G; ``seq_nms_batch.plain_calls``);
7. frame NMS: ``frame_nms(backend="pallas")`` over synthetic protos of 64
   frames × 30 classes equals the ``host`` backend at 512 and 1,024 boxes
   (kernel D; frames of more than 512 detections) and at 128 (kernel C);
   so does ``backend="fixpoint"`` (the Jacobi form, no hand kernel) at 512
   and 128, with its wall and peak device memory;
8. staged detect → track: the same models through the stages' entry
   points at the detect and track tools' defaults, frames in memory:
   ``det_vid`` with ``device_resize`` over 96 native 360×480 frames with 128
   proposals each (batches of 8 resized to 240×320 by kernel E), ``det_vid``
   with the pyramid (0.75, 1.0, 1.25) over 96 frames at 240×320 (E for 0.75
   and 1.25), and ``track_from_det`` over the first det_proto (32 tracks, 8
   anchors a round, stride 2; kernel F once per round); kernels E and F
   must launch;
9. stream engines: phase 6's videos and calibrated options through the
   host engine (``engine="host"``: the stages one call at a time, the
   seeding on the host) at ``track_stride`` 1, equal to phase 6's fused
   results, and both engines at ``track_stride`` 2, equal to each other —
   bit for bit, as the JAX engine-parity tests require; then both at
   strides 1 and 2 on the 100-frame video with ``conf_thresh`` raised so
   that tracks die and slots are seeded again in later chunks. Asserted
   first: tracks across chunk boundaries, backtracked entries, boundary
   fills at a chunk's last frame (stride 2), detection boxes independent
   of the stride, and (raised threshold) seeds in two chunks or more.
   Kernels A, B and C must launch in the host engine (counted apart from
   phases 5–8). Where the engines differ, the first chunk and stage that
   differ are printed and the phase fails. Prints ms per full chunk and
   frames/s for each engine and stride, and the ``stream.track_features``
   and ``stream.track_chunk`` spans at both strides (profiler, fused step).

10. fused sweep: phase 5's models are saved with ``save_params`` and
   loaded with ``load_params`` into models built from other seeds (every
   tensor equal bit for bit; file sizes and load time printed); those
   models run ``run_videos_fused`` over phase 5's three videos, frames in
   memory, with a ``PipelineConfig`` whose ``fused_config_from_pipeline``
   is phase 5's ``FusedConfig`` (its calibrated ``anchor_thresh``
   included); each video's ``final.json`` and ``tubelets.json`` must equal,
   byte for byte, ``fused_to_protos`` of a direct call of phase 5's
   pipeline on the same inputs; ``group_size`` 2 must equal 1 byte for
   byte; a second run must write nothing; with ``keep_going`` a fourth
   entry without proposals is marked failed and the other three complete,
   and without it the sweep raises. Kernels A, B and F must launch in the
   sweep (counted apart from phases 5–9). Prints the sweep's frames/s
   (valid frames over the wall of ``run_videos_fused``: loading, upload,
   pipeline and proto writes) beside phase 5's pipeline-only rate, the
   seconds the main thread waited on the prefetch thread, and the peak
   device memory. The ``pipeline`` tool itself reads JPEG frames, which
   needs ``cv2`` (absent on the card's machine), so the tool runs in the
   CPU tests (tests/test_torch_fused_runner.py and, with the staged engine,
   tests/test_torch_staged_runner.py), not here.
11. staged chain: phase 8's det_proto and track_proto over its 96 native
   360×480 frames, in memory, through the staged stages at the tools'
   defaults with phase 8's base detector (rebuilt from its seed): ``mgp``
   (window 1, "fastest", host dedup; kernel A exactly twice, forward and on
   the flipped frames), ``perturb_rescore_track_proto`` (8 perturbations,
   seed 0, 32 frames a batch), ``tubelet_rescore`` on the perturbed
   track_proto, and ``seq_nms_video`` with the ``device`` (kernel G once)
   and the ``host`` backends (the same paths, boxes and entries; scores
   within 1e-5). Then
   ``mgp``, ``tubelet_rescore`` and ``seq_nms_video`` again on the CPU, each
   fed the card stage's input: the same (frame, class) entries, boxes
   within 0.5 px, scores within 0.01, the same seq-NMS paths. A one-frame
   video through ``mgp`` launches no A and equals the CPU. Prints each
   stage's wall, A's launches and its device ms at the MGP shape (phase 3),
   and the peak device memory.
12. staged sweep: phase 10's loaded models run ``run_videos`` over phase
   10's three videos (frames in memory) at the ``pipeline`` tool's stage
   defaults (batch 8, 32 proposals, score_thresh 0.05, MGP window 1
   "fastest", 16 tracks at stride 2, 100 seq-NMS paths) with phase 10's
   calibrated ``anchor_thresh``: every stage file of each video
   (``detect``, ``mgp``, ``track``, ``score``, ``rescored``, ``final``,
   ``tubelets``) must equal, byte for byte, the stages called one by one
   on the same inputs; kernel A launches exactly twice a video, F at least
   once a video that seeds a track, B–E never. A second run writes nothing
   (every ``st_mtime_ns`` kept); with one video's ``final.json`` and
   ``tubelets.json`` deleted, the next run writes those two alone, with the
   same bytes, and launches no A or F. ``workers`` 2 over the two shorter
   videos (two threads' launches of A and F on the card at once) writes
   the same bytes. With ``keep_going`` a fourth entry one frame short is
   marked failed while the other three complete (they resume), and
   without it the sweep raises. Then phase 4's tiny float32 models through
   ``run_video`` and the fused pipeline at tests/test_fused_parity.py's
   matched configuration, at its default fixture and at its varying slot
   layout (asserted): the same (frame, class) keys and counts, scores
   within rtol 1e-4 / atol 1e-5, boxes within rtol 1e-4 / atol 1e-3.
   Prints the sweep's frames/s beside phase 10's fused sweep, each stage's
   wall summed over the videos (``StageMetrics``), the ``workers`` 2 wall
   beside the same videos' direct chain, and the peak device memory.

13. options: detection snapping (0.5), tubelet boxes and the "accurate"
   flow pyramid, with EMA templates (template_eta 0.1) and then with three
   scales in their place, at the ``base`` model's full width: phase 5's
   pipeline over its 64- and 50-frame videos (kernel A 6 times a video, F
   never; in a control run without snapping and EMA F at least once a
   video), printed in frames/s beside phase 5's rate; the torch scan's ms
   for phase 3's 48-step round (snapping with EMA, three scales) beside
   F's; phase 10's loaded models through ``run_videos`` and
   ``run_videos_fused`` with every option over two videos (A 6 times a
   video, F never; each staged file equal to the stages called one by
   one, byte for byte); the tiny float32 pipeline with every option, card
   == CPU within phase 4's bounds, and its staged chain == its fused
   pipeline (both fixtures of phase 12); the stream at the tool's defaults
   with EMA templates over 64 frames, fused == host bit for bit at strides
   1 and 2, and the tiny stream with EMA at both strides and engines, card
   == CPU over 12 frames.

14. training: one tiny float32 step of the detector and of the tracker's
   "pair" and "aware" recipes, the same weights and batch on the card and
   on the CPU (loss within 1e-5 relative; every gradient within 1e-4 of
   its tensor's largest magnitude, the tracker's 1e-3: see
   tests/test_torch_tracker_train.py), then the optimizer on the card
   given the CPU's gradients (parameters within 1e-6); TRAIN_STEPS steps
   of the ``base`` detector (C=31, 240×320, batch 8, 64 ROIs, cosine
   schedule) and of the default tracker for each recipe ("aware" on the
   hard tier), losses finite and the mean of the last 5 below the first 5,
   ms a step (CUDA events), steps/s, peak memory and the device time of a
   step by kind of kernel (torch.profiler) printed; the trainer's
   held-out eval (``evaluate_heldout_map``) with the trained ``base``
   weights, which must launch kernel C (its count is C's
   ``launches_train``), C's keep sets equal to its plain version on the
   eval's own (frames × 31, 64) problems; a train-state save, load and
   resume, bit for bit (cuDNN deterministic for that check); the
   ``train_detector`` tool through ``main`` with ``--eval_every`` on the
   card, whose checkpoint ``load_params`` loads into the fused pipeline's
   detector. Prints "phase 14 took N s".

15. serve: the serving daemon (``cli/serve.py``) over phase 10's three
   videos, queued as ``NAME.vid.json`` (placeholder paths) and
   ``NAME.box.json`` with the frames handed to ``serve_loop`` in memory,
   with the ``base`` detector (C=31, 240×320, R=64) and the default tracker
   loaded from phase 10's ``save_params`` checkpoints through
   ``build_models`` (``--detector_weights``/``--tracker_weights``; equal
   bit for bit to phase 10's loaded models), at ``serve_config``'s config
   with only ``track.anchor_thresh`` replaced by phase 10's calibrated
   value: ``--engine fused`` and then ``--engine staged``, each ``once``
   into its own workdir. Every video must be served by the engine asked
   for; the fused files must equal ``FusedEngine.load`` + ``run`` and the
   staged files ``run_video``, byte for byte; A, B (fused only) and F must
   launch (B never on the staged engine); no lock and no quarantine may be
   left; a second pass must take no video and write nothing; with
   ``--engine fused`` a video without its box proto (its detect stage in
   its workdir) must be served by the staged engine, equal to
   ``run_video``; a ``KernelError`` injected into the fused engine must
   leave ``serve_loop`` with no staged retry and no quarantine. Then the
   host tools through the port's dispatcher over the fused outputs and the
   videos' annotations: ``calibrate`` (rank, and platt fit on the three
   pairs with ``--save_model``), ``write_submission --calibration`` (every
   line in tests/test_vid_rehearsal.py's format, frames numbered globally)
   and ``eval_vid --json_out`` (its mAP equal to ``vid_map`` of the same
   pairs, printed, not gated). Prints each engine's ms per video from the
   lock to ``final.json`` (synchronised), its frames/s beside phase 10's
   fused sweep and phase 12's staged sweep, its peak device memory, and
   "phase 15 took N s".

16. multihost: a one-rank NCCL group through ``init_multihost`` (from
   MASTER_ADDR 127.0.0.1, a free port, WORLD_SIZE 1, RANK 0) and its
   ``(data, model)`` mesh. (a) ``make_sharded_pipeline`` at phase 5's
   config over V = 2 of its snippets (64 frames, 50 padded to 64): every
   field equal bit for bit to the two single calls, A's, B's and F's
   launches twice one call's, its wall beside theirs. (b) One step of
   phase 14's ``base`` recipe with the mesh against ``train_step`` without
   it, same batch and state, cuDNN deterministic: gradients, parameters and
   loss terms within 1e-6 of each tensor's largest; ms a step of each and
   the gradient all-reduce alone. (c) ``pipeline --multihost --engine
   fused`` over phase 10's videos (frames in memory) from its checkpoints:
   each ``final.json`` and ``tubelets.json`` equal byte for byte to direct
   pipeline calls at the tool's config; ``allreduce_metrics`` returns its
   input. Then the group is destroyed. (d) Phase 5's MFU: the analytic
   FLOPs of each call (``utils/flops.py``) over its wall × the bf16
   tensor-core peak, beside phase 5's frames/s. (e) ``profiling.device_trace``
   of one fused call: the Chrome trace names ``fused.seq_nms``. (f)
   ``frame_nms --backend host`` at 512 boxes a frame: the native library's
   keep sets (``csrc/nms_host.cpp``) equal to the numpy greedy's, both walls
   printed. Prints "phase 16 took N s".

Around each of phases 5–8, 11 and 12 the kernels' launch counters are
zeroed just before and read just after; a kernel's ``launches`` in the
record is the count from its own path (A, B: fused slice; C: stream; D:
frame NMS; E, F: staged path); A's record also holds
``launches_staged_chain`` (phase 11), its ``mgp_shape`` times and its
``float32_shapes`` times (phase 3), A's and F's ``launches_staged_sweep``
(phase 12); phase 13 counts its own runs apart, phase 14 its eval's C
(``launches_train``), phase 15 A's, B's and F's on each engine
(``launches_serve``), phase 16 theirs in the sharded pipeline and
``pipeline --multihost`` (``launches_multihost``). B–E are then ranked by their
device loss over phases 5–8, launches × (device ms − bound ms).

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
from vdetlib_tpu_torch.utils.flops import HBM_BYTES_PER_S
from vdetlib_tpu_torch.utils.flops import PEAK_BF16_FLOPS as BF16_OPS_PER_S
from vdetlib_tpu_torch.utils.flops import PEAK_F32_FLOPS as F32_OPS_PER_S

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
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events).

    The wall per call: where the device finishes a launch sooner than the
    host enqueues the next, this is the host's rate, not the kernel's."""
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


PROFILE_ATTEMPTS = 3


def device_records(fn, iters: int, kernel: str | None = None) -> list:
    """(name, µs) of every device activity (kernels, copies, fills) of
    ``iters`` calls of ``fn``, from torch.profiler's CUPTI records. A
    ``record_function`` range that the profiler also lays on the device's
    timeline (``Optimizer.step#...``: a user annotation, spanning kernels
    listed on their own) is no activity and is left out.

    A trace now and then comes back without the records of a kernel that
    ran (once in the smoke run's ~20 traces on the H100, at a shape whose
    other traces held them): while no record's name contains ``kernel``
    (with ``kernel`` None: while there is no device record at all) the
    calls are traced again, up to ``PROFILE_ATTEMPTS`` times, and the retry
    is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        recs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if any(kernel is None or kernel in name for name, _ in recs):
            return recs
        log(f"profiler: trace {attempt} of {iters} calls holds no device record of "
            f"{kernel or 'the call'} ({len(recs)} device records); tracing again")
    raise AssertionError(f"the profiler saw no device time for {kernel or 'the call'}")


def device_ms(fn, iters: int, kernel: str | None = None):
    """Device milliseconds per call of ``fn`` over ``iters`` calls after one
    warm-up (``device_records``): (the kernels whose name contains
    ``kernel``, every other device activity: kernels, copies, fills). With
    ``kernel`` None every activity counts in the first."""
    fn()
    torch.cuda.synchronize()
    recs = device_records(fn, iters, kernel)
    own = sum(us for name, us in recs if kernel is None or kernel in name)
    other = sum(us for name, us in recs if not (kernel is None or kernel in name))
    assert own > 0, f"the profiler saw no device time for {kernel or 'the call'}"
    return own / iters / 1e3, other / iters / 1e3


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of ``fn``: a perf_counter loop with no
    synchronisation, what a call costs its caller's thread."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def kernel_times(fn, kernel: str, iters: int) -> dict:
    """One hand kernel's call ``fn`` timed three ways: ``ms`` the wall per
    call (CUDA events), ``device_ms`` its kernel's device time per call
    (``other_device_ms`` the rest of the call's device work), ``host_us``
    the wrapper's host time per call. The profiler runs last: the first
    profiled loop of a process slows the host loops that follow it."""
    ms, us = cuda_ms(fn, iters), host_us(fn, iters)
    dev_ms, other_ms = device_ms(fn, iters, kernel)
    return dict(ms=ms, device_ms=dev_ms, other_device_ms=other_ms, host_us=us)


def fmt_times(t: dict) -> str:
    return (f"wall per call {t['ms']:.4f} ms, device {t['device_ms']:.5f} ms, "
            f"host {t['host_us']:.1f} us")


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


def jacobi_steps(boxes, scores, valid, thresh, groups=None):
    """Jacobi steps of ``keep = valid ∧ ¬(M·keep)`` on this data, counted
    with the plain version's adjacency: for each problem the steps that
    change ``keep`` (a kernel runs one more, which confirms the fixpoint).
    Returns (max, mean) over the problems."""
    from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET, pairwise_iou

    m = ((pairwise_iou(boxes, boxes, offset=LEGACY_OFFSET) > thresh)
         & _precedes(scores, valid) & valid[:, None, :])
    if groups is not None:
        m &= groups[:, :, None] == groups[:, None, :]
    keep = valid.clone()
    steps = torch.zeros(valid.shape[0], dtype=torch.int64, device=valid.device)
    for _ in range(valid.shape[1]):
        new = valid & ~(m & keep[:, None, :]).any(-1)
        changed = (new != keep).any(-1)
        if not bool(changed.any()):
            break
        steps += changed
        keep = new
    return int(steps.max()), float(steps.float().mean())


def fixpoint_iou_count(scores, valid, groups=None) -> int:
    """IoUs the Jacobi fixpoint needs on this data: one per valid slot i and
    valid slot j of its group that precedes it (the <= N steps of word ANDs
    on the adjacency bitmasks are not counted)."""
    pair = _precedes(scores, valid) & valid[:, :, None] & valid[:, None, :]
    if groups is not None:
        pair &= groups[:, :, None] == groups[:, None, :]
    return int(pair.sum())


def greedy_iou_count(boxes, scores, valid, thresh, keep) -> int:
    """IoUs the sorted greedy walk needs on this data, given its keep set
    (input order): for each kept box i, one per later valid box not yet
    suppressed when step i runs."""
    from vdetlib_tpu_torch.geometry.boxes import pairwise_iou
    from vdetlib_tpu_torch.kernels.nms_sorted import visit_order

    total, n = 0, boxes.shape[1]
    chunk = max(1, 2**23 // (n * n))
    idx = torch.arange(n, device=boxes.device)
    later = idx[None, :] > idx[:, None]  # (i, j): j after i
    for c in range(0, boxes.shape[0], chunk):
        b, s, v = boxes[c:c + chunk], scores[c:c + chunk], valid[c:c + chunk]
        order = visit_order(s, v)
        sb = torch.gather(b, 1, order[..., None].expand(b.shape))
        sv = torch.gather(v, 1, order)
        kept = torch.gather(keep[c:c + chunk], 1, order)
        sup = (pairwise_iou(sb, sb) > thresh) & kept[:, :, None] & later[None]
        first = torch.where(sup.any(1), sup.int().argmax(1), n)  # (B, j) first suppressor
        need = kept[:, :, None] & sv[:, None, :] & later[None] & (idx[None, :, None] <= first[:, None, :])
        total += int(need.sum())
    return total


def quarter_gray(frames_u8, dev):
    """The "fastest" preset's bf16 quarter-resolution gray frames on ``dev``."""
    from vdetlib_tpu_torch.kernels import flow as tflow

    frames = torch.from_numpy(frames_u8).to(dev)
    return tflow._avg_pool2(tflow._avg_pool2(tflow.to_gray(frames))).to(torch.bfloat16)


def flow_check(label, gray, gt_boxes, P):
    """Kernel A over the first P pairs of ``gray`` against its plain version:
    the box shifts of ``gt_boxes`` (K, T, 4, full-res) within mean < 0.05,
    max < 0.5 full-res px; timed (``kernel_times``) beside its bound."""
    from vdetlib_tpu_torch.kernels import flow as tflow
    from vdetlib_tpu_torch.kernels import flow_level as kl

    scale = tflow.flow_coord_scale("fastest")
    search, radius = 5, 3  # flow_level's defaults, as the "fastest" preset calls it
    # operations per pixel and shift: the squared difference (2), the
    # separable 7x7 box sum (2 x 6 adds), the division by the area (1) and
    # the online soft-argmin (min, 2 sub, 2 mul, 2 exp, den: mul + add, fx
    # and fy: 2 mul + add each = 15)
    per_shift = 2 + 2 * (2 * radius) + 1 + 15
    i1, i2 = gray[:P].contiguous(), gray[1:P + 1].contiguous()
    got = kl.flow_level(i1, i2)
    want = kl._flow_level(i1, i2)
    torch.cuda.synchronize()
    boxes = torch.from_numpy(gt_boxes[:, :P].transpose(1, 0, 2).copy()).to(gray.device)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=gray.device)
    d = (tflow.mean_flow_in_boxes(got, boxes * scale, valid)
         - tflow.mean_flow_in_boxes(want, boxes * scale, valid)).abs() / scale  # full-res px
    err, mean = float(d.max()), float(d.mean())
    field_err = float((got - want).abs().max())
    t = kernel_times(lambda: kl.flow_level(i1, i2), "flow_level_kernel", iters=20)
    _, Hq, Wq = i1.shape
    t["bound_ms"], t["bound_by"] = bound(i1.numel() * 2 * 2 + got.numel() * 4,
                                         P * Hq * Wq * (2 * search + 1) ** 2 * per_shift)
    log(f"kernel flow_level {label} P={P} {tuple(i1.shape)} bf16: {fmt_times(t)} (bound "
        f"{t['bound_ms']:.6f} by {t['bound_by']}); box-shift err mean {mean:.6f} max {err:.6f} "
        f"px (tolerance mean < 0.05, max < 0.5); field max |diff| {field_err:.6f} cells")
    assert math.isfinite(err) and mean < 0.05 and err < 0.5, f"flow kernel disagrees at P={P}"
    t["max_abs_err"] = err
    return t, (i1, i2)


def flow_case(dev, times):
    """Kernel A against its plain version on the quarter-res gray pairs of a
    256-frame video (the first P pairs), at the pair counts its paths launch
    and at 255, and at the staged MGP's shape (95 pairs of 90×120: the 96
    native 360×480 frames of phases 8 and 11): box shifts within mean <
    0.05, max < 0.5 full-res px at every P; timed at every shape, the plain
    version at 255."""
    from vdetlib_tpu_torch.kernels import flow_level as kl

    sv = synth(256, seed=0)
    gray = quarter_gray(sv.frames, dev)
    ms_by_p, dev_by_p, worst = {}, {}, 0.0
    for P in FLOW_PAIRS:
        t, pair = flow_check("video", gray, sv.gt_boxes, P)
        ms_by_p[P], dev_by_p[P] = t["ms"], t["device_ms"]
        worst = max(worst, t["max_abs_err"])
    plain_ms = cuda_ms(lambda: kl._flow_level(*pair), iters=5)
    native = staged_video(NATIVE_HW)
    m, _ = flow_check("MGP", quarter_gray(native.frames, dev), native.gt_boxes, STAGED_T - 1)
    worst = max(worst, m["max_abs_err"])
    mgp_shape = {k: m[k] for k in ("ms", "device_ms", "host_us", "bound_ms", "bound_by",
                                   "max_abs_err")}
    mgp_shape["shape"] = [STAGED_T - 1, NATIVE_HW[0] // 4, NATIVE_HW[1] // 4]
    log(f"kernel flow_level bf16 at P=255: device {dev_by_p[255]:.5f} ms against PERF.md's "
        f"{PERF_A_BF16_255:.5f} ({dev_by_p[255] / PERF_A_BF16_255 - 1:+.1%}; the float32 path "
        f"shares the bf16 kernel's code: within 5% expected)")
    f32, f32_err, f32_plain, flow_video_ms = flow_f32_case(dev)
    worst = max(worst, f32_err)
    times.append(f"flow_level kernel {t['ms']:.4f} device {t['device_ms']:.5f} plain "
                 f"{plain_ms:.4f} bound {t['bound_ms']:.4f} (P={P}; by P: wall {ms_by_p}, "
                 f"device {dev_by_p}; MGP {tuple(mgp_shape['shape'])}: wall {m['ms']:.4f}, "
                 f"device {m['device_ms']:.5f}, bound {m['bound_ms']:.6f}; float32 levels: "
                 + ", ".join(f"{k} device {v['device_ms']:.5f} bound {v['bound_ms']:.6f}"
                             for k, v in f32.items())
                 + f"; float32 plain at {FLOW_F32_PLAIN}: {f32_plain:.4f})")
    return dict(name="flow_level", route="cuda", source="vdetlib_tpu_torch/csrc/flow_level.cu",
                replaces="vdetlib_tpu/kernels/flow_pallas.py:104", max_abs_err=worst, ms=t["ms"],
                device_ms=t["device_ms"], host_us=t["host_us"], ms_by_p=ms_by_p,
                device_ms_by_p=dev_by_p, mgp_shape=mgp_shape, float32_shapes=f32,
                float32_plain_ms=f32_plain, flow_video_ms=flow_video_ms, plain_ms=plain_ms,
                bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


# the "accurate" pyramid's float32 levels for 240×320 frames (full, half,
# quarter) at the fused slice's 63 pairs and a 256-frame video's 255, and
# the finest level of the staged MGP's 96 native 360×480 frames; search 3
# (the pyramid's default), radius 3
PYRAMID_SHAPES = tuple((P, H >> lvl, W >> lvl) for P in (63, 255) for lvl in range(3))
FLOW_F32_PLAIN = (63, H, W)  # where the plain version is timed
PERF_A_BF16_255 = 0.30567  # PERF.md §6, kernel A's device ms at P = 255 (bf16)


def flow_f32_case(dev):
    """Kernel A's float32 path against its plain version at the pyramid's
    level shapes (``PYRAMID_SHAPES``) and at the staged MGP's finest level
    (95 × 360×480): the box shifts of the objects' boxes within mean < 0.05,
    max < 0.5 full-resolution px; each timed (``kernel_times``) beside its
    bound. Returns ({"PxHxW": times}, the worst shift error, the plain
    version's ms at ``FLOW_F32_PLAIN``, {preset: ``flow_video`` wall ms of
    64 frames})."""
    from vdetlib_tpu_torch.kernels import flow as tflow
    from vdetlib_tpu_torch.kernels import flow_level as kl

    search, radius = 3, 3
    per_shift = 2 + 2 * (2 * radius) + 1 + 15  # as in flow_check
    sv = synth(256, seed=0)
    levels = [tflow.to_gray(torch.from_numpy(sv.frames).to(dev))]
    for _ in range(2):
        levels.append(tflow._avg_pool2(levels[-1]))
    native = staged_video(NATIVE_HW)
    shapes = [(P, h, w, levels[i % 3], sv.gt_boxes) for i, (P, h, w) in enumerate(PYRAMID_SHAPES)]
    shapes.append((STAGED_T - 1, *NATIVE_HW,
                   tflow.to_gray(torch.from_numpy(native.frames).to(dev)), native.gt_boxes))
    recs, worst, plain_ms = {}, 0.0, None
    for P, h, w, gray, gt in shapes:
        assert gray.shape[1:] == (h, w)
        scale = h / (NATIVE_HW[0] if gt is native.gt_boxes else H)  # level / frame
        i1, i2 = gray[:P].contiguous(), gray[1:P + 1].contiguous()
        got = kl.flow_level(i1, i2, search=search, radius=radius)
        want = kl._flow_level(i1, i2, search, radius)
        torch.cuda.synchronize()
        boxes = torch.from_numpy(gt[:, :P].transpose(1, 0, 2).copy()).to(dev)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
        d = (tflow.mean_flow_in_boxes(got, boxes * scale, valid)
             - tflow.mean_flow_in_boxes(want, boxes * scale, valid)).abs() / scale
        err, mean = float(d.max()), float(d.mean())
        assert math.isfinite(err) and mean < 0.05 and err < 0.5, \
            f"flow kernel (float32) disagrees at {(P, h, w)}"
        worst = max(worst, err)
        t = kernel_times(lambda: kl.flow_level(i1, i2, search=search, radius=radius),
                         "flow_level_kernel", iters=10)
        t["bound_ms"], t["bound_by"] = bound(i1.numel() * 4 * 2 + got.numel() * 4,
                                             P * h * w * (2 * search + 1) ** 2 * per_shift)
        t["max_abs_err"] = err
        recs[f"{P}x{h}x{w}"] = t
        log(f"kernel flow_level float32 P={P} {(h, w)} s={search}: {fmt_times(t)} (bound "
            f"{t['bound_ms']:.6f} by {t['bound_by']}); box-shift err mean {mean:.6f} max "
            f"{err:.6f} px (tolerance mean < 0.05, max < 0.5)")
        if (P, h, w) == FLOW_F32_PLAIN:
            plain_ms = cuda_ms(lambda: kl._flow_level(i1, i2, search, radius), iters=3)
    frames = torch.from_numpy(sv.frames[:64]).to(dev)  # the fused slice's bucket
    walls = {preset: cuda_ms(lambda: tflow.flow_video(frames, preset=preset, upsample=False),
                             iters=10) for preset in ("accurate", "fastest")}
    log(f"flow_video of 64 frames at {(H, W)} on the card, wall per call: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in walls.items())
        + " (accurate: 3 float32 levels of A, the upsampling and warps; fastest: one bf16 level)")
    return recs, worst, plain_ms, walls


NMS_THRESH = 0.3  # the engines' default nms_thresh
# kernel B's timed shapes (name, problems, slots, groups): the fused slice's
# dedup (frames x 3 x 64 slots, 30 class groups), the stream's MGP dedup
# through batched_nms (one group) for one frame's 192 slots x 32 frames, and
# at the size the stream launches it: a full chunk of 32 frames x 30 classes
GROUPED_SHAPES = (("fused", 256, 192, 30), ("stream 32", 32, 192, 1), ("stream", 960, 192, 1))


def nms_run(name, kernel, plain, args, iou_count, iters):
    """One NMS kernel at one shape: keep sets identical to the plain version,
    timed (``kernel_times``) beside its bound. ``args`` = boxes, scores,
    valid (, groups); ``iou_count`` the IoUs the function needs, or a
    function of the plain keep set that counts them."""
    keep = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    if callable(iou_count):  # counted from the plain keep set
        iou_count = iou_count(ref)
    n_diff = int((keep != ref).sum())
    Bn, N = args[1].shape
    n_valid = int(args[2].sum())
    assert n_diff == 0, f"{name} kernel disagrees at ({Bn}, {N})"
    assert 0 < int(keep.sum()) < n_valid, f"{name}: the problem suppresses nothing"
    t = kernel_times(lambda: kernel(*args), f"{name}_kernel", iters)
    n_bytes = sum(a.numel() * a.element_size() for a in args) + keep.numel()
    t["bound_ms"], t["bound_by"] = bound(n_bytes, AREA_OPS * Bn * N + IOU_OPS * iou_count)
    t.update(n_diff=n_diff, kept=int(keep.sum()), valid=n_valid, ious=iou_count)
    return t


def nms_record(name, replaces, t, plain_ms, **extra):
    return dict(name=name, route="cuda", source=f"vdetlib_tpu_torch/csrc/{name}.cu",
                replaces=replaces, max_abs_err=float(t["n_diff"]), ms=t["ms"],
                device_ms=t["device_ms"], host_us=t["host_us"], plain_ms=plain_ms,
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None, **extra)


def grouped_case(dev, times):
    """Kernel B at each of GROUPED_SHAPES: keep sets identical to the plain
    version, the fixpoint's Jacobi steps (plain version), timed; the record's
    own figures are the fused shape's, every shape's under ``shapes``."""
    from vdetlib_tpu_torch.kernels import nms_grouped as kb

    th = NMS_THRESH
    shapes, plain_ms = {}, None
    for i, (label, Bn, N, n_groups) in enumerate(GROUPED_SHAPES):
        args = [torch.from_numpy(a).to(dev)
                for a in nms_problem(Bn, N, seed=1 + 10 * i, groups=max(n_groups, 1))]
        if n_groups == 1:  # batched_nms's one group: every slot 0
            args[3] = torch.zeros_like(args[3])
        t = nms_run("nms_grouped", lambda b, s, v, g: kb.nms_grouped_kernel(b, s, v, g, th),
                    lambda b, s, v, g: kb.nms_unsorted_fixpoint(b, s, v, th, groups=g), args,
                    fixpoint_iou_count(*args[1:]), iters=50)
        t["steps_max"], t["steps_mean"] = jacobi_steps(*args[:3], th, groups=args[3])
        log(f"kernel nms_grouped {label} ({Bn}, {N}, {n_groups} groups): keep identical "
            f"({t['kept']} of {t['valid']} valid kept); {fmt_times(t)}; bound "
            f"{t['bound_ms']:.6f} ms ({t['ious']} IoUs); Jacobi steps max {t['steps_max']} "
            f"mean {t['steps_mean']:.2f} (+1 to confirm)")
        if plain_ms is None:
            plain_ms = cuda_ms(lambda: kb.nms_unsorted_fixpoint(*args[:3], th, groups=args[3]),
                               iters=10, warmup=1)
        shapes[label] = {k: t[k] for k in ("ms", "device_ms", "host_us", "bound_ms", "bound_by",
                                           "ious", "steps_max", "steps_mean")}
        times.append(f"nms_grouped {label} kernel {t['ms']:.4f} device {t['device_ms']:.5f} "
                     f"bound {t['bound_ms']:.6f}" + (f" plain {plain_ms:.4f}" if i == 0 else ""))
    return nms_record("nms_grouped", "vdetlib_tpu/kernels/nms_pallas.py:261",
                      dict(shapes["fused"], n_diff=0), plain_ms,
                      steps=shapes["fused"]["steps_max"], shapes=shapes)


def batched_case(dev, times):
    """Kernel C at the stream's per-frame per-class NMS, 32 frames x 30
    classes x 64 slots: keep sets identical, Jacobi steps, timed."""
    from vdetlib_tpu_torch.kernels import nms_batched as kc
    from vdetlib_tpu_torch.kernels import nms_grouped as kb

    th = NMS_THRESH
    args = [torch.from_numpy(a).to(dev) for a in nms_problem(32 * 30, 64, seed=2)]
    t = nms_run("nms_batched", lambda *a: kc.nms_batched_kernel(*a, th),
                lambda *a: kb.nms_unsorted_fixpoint(*a, th), args,
                fixpoint_iou_count(*args[1:]), iters=50)
    steps = jacobi_steps(*args, th)
    plain_ms = cuda_ms(lambda: kb.nms_unsorted_fixpoint(*args, th), iters=10, warmup=1)
    log(f"kernel nms_batched (960, 64): keep identical ({t['kept']} of {t['valid']} valid kept); "
        f"{fmt_times(t)}; bound {t['bound_ms']:.6f} ms ({t['ious']} IoUs); Jacobi steps max "
        f"{steps[0]} mean {steps[1]:.2f} (+1 to confirm)")
    times.append(f"nms_batched kernel {t['ms']:.4f} device {t['device_ms']:.5f} plain "
                 f"{plain_ms:.4f} bound {t['bound_ms']:.6f}")
    return nms_record("nms_batched", "vdetlib_tpu/kernels/nms_pallas.py:186", t, plain_ms,
                      steps=steps[0], steps_mean=steps[1])


# kernel G's timed shapes (frames; 30 class lanes of 64 slots, 100 paths):
# the benchmark sweep's median video (282 frames in the 288 bucket) and its
# longest bucket
SEQ_NMS_FRAMES = (288, 480)
SEQ_NMS_LANES, SEQ_NMS_SLOTS, SEQ_NMS_PATHS = 30, 64, 100


def seq_nms_problem(C, T, N, seed, ties=False):
    """A seq-NMS problem like the fused sweep's: boxes (T, N, 4) following
    N // 4 drifting objects with jitter (links across frames, overlaps
    within them), each frame's slots in a new order; scores (C, T, N),
    with ``ties`` on a coarse grid and slot 1 a copy of slot 0 (box and
    score: tied dp values); mask (C, T, N): ~85% valid and a padded invalid
    tail of N // 8 slots. Shared with tests/test_torch_kernels_cuda.py."""
    rng = np.random.default_rng(seed)
    K = max(1, N // 4)
    start = make_rois(1, seed, r=K)[0].astype(np.float64)  # (K, 4)
    step = np.repeat(rng.normal(0, 2.0, (K, 2)), 2, axis=1)[:, [0, 2, 1, 3]]
    objs = start[None] + step[None] * np.arange(T)[:, None, None]  # (T, K, 4)
    boxes = objs[:, rng.integers(0, K, N)] + rng.normal(0, 3.0, (T, N, 4))
    boxes = np.take_along_axis(boxes, np.argsort(rng.uniform(size=(T, N)), 1)[..., None], 1)
    boxes = boxes.astype(np.float32)
    scores = rng.uniform(0.05, 1.0, (C, T, N)).astype(np.float32)
    if ties and N > 1:
        scores = (np.round(scores * 8) / 8).astype(np.float32)
        boxes[:, 1], scores[:, :, 1] = boxes[:, 0], scores[:, :, 0]
    mask = rng.uniform(size=(C, T, N)) > 0.15
    mask[:, :, N - N // 8:] = False
    return boxes, scores, mask


def seq_nms_equal(got, want, rescore):
    """Kernel G's (out, path_id) against the plain version's: path ids and
    -1 suppressions exactly, scores exactly under "max" and within 1e-6
    relative under "avg" (its sum in another order). Returns the paths."""
    (go, gp), (wo, wp) = ((o.cpu(), p.cpu()) for o, p in (got, want))
    assert torch.equal(gp, wp), f"path ids differ at {int((gp != wp).sum())} slots"
    assert torch.equal(go == -1, wo == -1), "suppressions differ"
    if rescore == "max":
        assert torch.equal(go, wo), "path scores differ"
    else:
        torch.testing.assert_close(go, wo, rtol=1e-6, atol=0)
    return int((wp.amax((1, 2)) + 1).sum())


def seq_nms_case(dev, times):
    """Kernel G at the sweep's seq-NMS (30 lanes × 64 slots, 100 paths) at
    T = 288 and 480: path ids, suppressions and scores equal the plain
    version's (timed once on the card), one G launch a call, the call's
    device kernels counted; timed beside the bound of
    ``utils/flops.py::seq_nms_flops`` over the float32 peak. That bound
    counts the dense (T - 1) · N² edges a path; G walks only the linked
    ones, whose share of the dense count is printed beside it."""
    from vdetlib_tpu_torch.kernels import seq_nms as kg
    from vdetlib_tpu_torch.utils.flops import seq_nms_flops

    shapes = {}
    for T in SEQ_NMS_FRAMES:
        C, N, paths = SEQ_NMS_LANES, SEQ_NMS_SLOTS, SEQ_NMS_PATHS
        args = [torch.from_numpy(a).to(dev) for a in seq_nms_problem(C, T, N, seed=T)]

        def call(a=args, paths=paths):
            return kg.seq_nms_kernel(*a, 0.5, 0.3, max_paths=paths)

        before = kg.seq_nms_kernel.launches
        got = call()
        torch.cuda.synchronize()
        assert kg.seq_nms_kernel.launches == before + 1, "kernel G did not launch once"
        t0 = time.perf_counter()
        want = kg.seq_nms_plain(*args, 0.5, 0.3, max_paths=paths)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        n_paths = seq_nms_equal(got, want, "avg")
        t = kernel_times(call, "seq_nms_kernel", iters=20)
        n_dev = len(device_records(call, 1))
        n_bytes = sum(a.numel() * a.element_size() for a in args) + C * T * N * 8
        t["bound_ms"], t["bound_by"] = bound(n_bytes, seq_nms_flops(T, N, C, paths))
        link = kg.link_masks(args[0], 0.5, 0.3)[0]
        linked = int(((link[..., None] >> torch.arange(64, device=dev)) & 1).sum())
        t.update(paths=n_paths, plain_ms=plain_ms, device_kernels_per_call=n_dev,
                 max_abs_err=float((got[0] - want[0]).abs().max()),
                 linked_share=linked / max(1, (T - 1) * N * N))
        shapes[T] = t
        log(f"kernel seq_nms ({C}, {T}, {N}), {paths} paths: path ids and suppressions equal "
            f"the plain version's ({n_paths} paths); {fmt_times(t)} (other device work "
            f"{t['other_device_ms']:.5f} ms, {n_dev} device kernels a call); bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}, dense edges; {100 * t['linked_share']:.3f}% "
            f"of them linked); plain {plain_ms:.1f} ms; scores within {t['max_abs_err']:.2e}")
        times.append(f"seq_nms T={T} kernel {t['ms']:.4f} device {t['device_ms']:.5f} plain "
                     f"{plain_ms:.1f} bound {t['bound_ms']:.6f}")
    t = shapes[SEQ_NMS_FRAMES[0]]
    return dict(name="seq_nms", route="cuda", source="vdetlib_tpu_torch/csrc/seq_nms.cu",
                replaces=None, max_abs_err=t["max_abs_err"], ms=t["ms"], device_ms=t["device_ms"],
                host_us=t["host_us"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None,
                shapes={T: {k: v[k] for k in ("ms", "device_ms", "other_device_ms", "host_us",
                                              "bound_ms", "bound_by", "plain_ms", "paths",
                                              "device_kernels_per_call", "linked_share")}
                        for T, v in shapes.items()})


def frame_nms_problems(T, max_boxes, seed):
    """Phase 7's protos of T frames x 30 classes as (T * 30, max_boxes)
    problems: boxes, scores, valid, packed as ``video/frame_nms.py::
    pack_frame_problems`` packs them for the card (the first ``max_boxes``
    detections of a frame in file order, a problem a frame and class). Kept
    here, from the protos alone, so that an earlier tree's kernels can be
    timed on the same problems (scripts/kernel_ab.py)."""
    from vdetlib_tpu_torch.protos.accessors import det_class_indices, frame_ids

    vid, det = frame_nms_protos(T, max_boxes, seed)
    fids, classes = frame_ids(vid), det_class_indices(det)
    row, col = {f: i for i, f in enumerate(fids)}, {c: i for i, c in enumerate(classes)}
    C, N = len(classes), max_boxes
    boxes = np.zeros((T, C, N, 4), np.float32)
    scores = np.zeros((T, C, N), np.float32)
    valid = np.zeros((T, C, N), bool)
    fill = np.zeros(T, np.int64)
    for d in det["detections"]:
        t = row[int(d["frame"])]
        n = fill[t]
        if n == N:
            continue
        fill[t] += 1
        boxes[t, :, n] = np.asarray(d["bbox"], np.float32)
        for sc in d["scores"]:
            scores[t, col[int(sc["class_index"])], n] = float(sc["score"])
            valid[t, col[int(sc["class_index"])], n] = True
    return [boxes.reshape(T * C, N, 4), scores.reshape(T * C, N), valid.reshape(T * C, N)]


def device_kernels(fn) -> list:
    """Names of the device activities (kernels, copies, fills) of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    return [name for name, _ in device_records(fn, 1)]


def sorted_bound(args, ious):
    """Kernel D's bound on this data, both counts: (ms, by) for the bytes the
    function must touch (valid and keep for every slot, box and score of each
    valid slot) with AREA_OPS a valid slot + IOU_OPS a greedy IoU; and (ms,
    by) with every slot's box and score read and an area for every slot,
    the count that reads the invalid slots too."""
    boxes, scores, valid = args
    n_slots, n_valid = valid.numel(), int(valid.sum())
    ops = IOU_OPS * ious
    need = bound(2 * n_slots + (16 + 4) * n_valid, AREA_OPS * n_valid + ops)
    every = bound(sum(a.numel() * a.element_size() for a in args) + n_slots,
                  AREA_OPS * n_slots + ops)
    return need, every


# kernel D's timed shapes (label, problems, slots, source): phase 3's dense
# problems at the frame-NMS tool's default budget, the tool's own (sparse)
# problems from phase 7's protos at that budget, and a 2,048-slot budget
SORTED_SHAPES = (("dense", NMS_FRAMES * 30, 512, "nms_problem"),
                 ("tool", NMS_FRAMES * 30, 512, "frame_nms"),
                 ("2048", NMS_FRAMES * 30, 2048, "nms_problem"))


def sorted_case(dev, times):
    """Kernel D at SORTED_SHAPES (the 2,048-slot shape where the tree's D
    takes it): keep sets identical to the plain version; device time of the
    whole call (the kernel and any torch work around it, apart) and the
    device activities of one call; the bound recounted on each shape's
    valid slots. The record's own figures are the dense shape's, every
    shape's under ``shapes``."""
    from vdetlib_tpu_torch.kernels import nms_sorted as kd

    th = NMS_THRESH
    shapes, plain_ms, kernels_per_call = {}, None, None
    for label, Bn, N, source in SORTED_SHAPES:
        if N > kd.MAX_SLOTS:
            log(f"kernel nms_sorted {label} ({Bn}, {N}): over this tree's limit of "
                f"{kd.MAX_SLOTS} slots, not run")
            continue
        arrs = (nms_problem(Bn, N, seed=3) if source == "nms_problem"
                else frame_nms_problems(Bn // 30, N, seed=N))
        args = [torch.from_numpy(a).to(dev) for a in arrs]
        t = nms_run("nms_sorted", lambda *a: kd.nms_sorted_kernel(*a, th),
                    lambda *a: kd.nms_sorted_greedy(*a, th), args,
                    lambda ref: greedy_iou_count(*args, th, ref), iters=20)
        (t["bound_ms"], t["bound_by"]), (every_ms, every_by) = sorted_bound(args, t["ious"])
        t["kernel_device_ms"] = t["device_ms"]
        t["device_ms"] = t["kernel_device_ms"] + t["other_device_ms"]  # the whole call
        names = device_kernels(lambda: kd.nms_sorted_kernel(*args, th))
        n_valid = args[2].sum(1)
        log(f"kernel nms_sorted {label} ({Bn}, {N}; valid a problem mean "
            f"{float(n_valid.float().mean()):.1f}, max {int(n_valid.max())}, <= 32 in "
            f"{int((n_valid <= 32).sum())}): keep identical ({t['kept']} of {t['valid']} valid "
            f"kept); {fmt_times(t)} for the whole call (its kernel {t['kernel_device_ms']:.5f}, "
            f"other device work {t['other_device_ms']:.5f}); {len(names)} device activities a "
            f"call; bound {t['bound_ms']:.6f} ms by {t['bound_by']} ({t['ious']} IoUs; "
            f"{every_ms:.6f} by {every_by} counting every slot's box and score)")
        if plain_ms is None:
            plain_ms = cuda_ms(lambda: kd.nms_sorted_greedy(*args, th), iters=2, warmup=1)
            kernels_per_call = len(names)
        shapes[label] = {k: t[k] for k in ("ms", "device_ms", "kernel_device_ms",
                                           "other_device_ms", "host_us", "bound_ms", "bound_by",
                                           "ious", "valid")}
        shapes[label].update(bound_ms_every_slot=every_ms, device_kernels_per_call=len(names))
        times.append(f"nms_sorted {label} device {t['device_ms']:.5f} (kernel "
                     f"{t['kernel_device_ms']:.5f}) bound {t['bound_ms']:.6f}"
                     + (f" plain {plain_ms:.4f}" if label == "dense" else ""))
    return nms_record("nms_sorted", "vdetlib_tpu/kernels/nms_pallas.py:354",
                      dict(shapes["dense"], n_diff=0), plain_ms, shapes=shapes,
                      device_kernels_per_call=kernels_per_call)


def nms_routes_case(dev, records):
    """The NMS routes around B's and D's limits, on the card against the
    CPU's plain versions: ``nms_grouped`` at 256 frames × 576 slots in 30
    groups (the fused dedup at ``mgp_window`` 4) runs the sort-free fixpoint
    in torch ops and launches no B, at 192 slots it launches B once;
    ``batched_nms`` over 2 problems of 8,200 slots (above D's 8,192) runs
    the fixpoint and launches no D. Keep sets identical; walls printed."""
    from vdetlib_tpu_torch.kernels import nms as knms
    from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel
    from vdetlib_tpu_torch.kernels.nms_sorted import nms_sorted_kernel

    cases = (("grouped", knms.nms_grouped, 256, 576, 30),
             ("grouped", knms.nms_grouped, 256, 192, 30),
             ("batched", knms.batched_nms, 2, 8200, 0))
    for i, (kind, fn, Bn, N, groups) in enumerate(cases):
        arrs = nms_problem(Bn, N, seed=40 + i, groups=groups)
        cpu = [torch.from_numpy(a) for a in arrs]
        args = [a.to(dev) for a in cpu]
        before = (nms_grouped_kernel.launches, nms_sorted_kernel.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = fn(*args, NMS_THRESH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = (nms_grouped_kernel.launches - before[0], nms_sorted_kernel.launches - before[1])
        want = fn(*cpu, NMS_THRESH)
        n_diff = int((keep.cpu() != want).sum())
        assert n_diff == 0, f"{kind} NMS at ({Bn}, {N}) on the card differs from the CPU"
        assert 0 < int(want.sum()) < int(cpu[2].sum()), f"({Bn}, {N}) suppresses nothing"
        route = knms.grouped_route(N) if kind == "grouped" else knms.batched_route(N)
        expect = (1, 0) if route == "kernel" else (0, 0)
        assert launched == expect, f"{kind} NMS at {N} slots launched (B, D) {launched}"
        log(f"route: {kind} NMS at ({Bn}, {N}{f', {groups} groups' if groups else ''}) takes "
            f"'{route}' on the card: keep identical to the CPU's plain version ({int(want.sum())} "
            f"of {int(cpu[2].sum())} valid kept), launches (B, D) {launched}, wall "
            f"{wall * 1e3:.1f} ms")
        rec = records["nms_sorted" if kind == "batched" else "nms_grouped"]
        rec.setdefault("routes", {})[f"{Bn}x{N}"] = dict(route=route, wall_ms=wall * 1e3,
                                                          n_diff=n_diff, launched=launched)


def phase_kernels(dev):
    """Kernels vs plain versions at their paths' shapes → kernel records."""
    times = []
    records = {"flow_level": flow_case(dev, times), "nms_grouped": grouped_case(dev, times),
               "nms_batched": batched_case(dev, times), "nms_sorted": sorted_case(dev, times),
               "resize_normalize": resize_case(dev, times),
               "track_scan": track_scan_case(dev, times), "seq_nms": seq_nms_case(dev, times)}
    nms_routes_case(dev, records)
    log("times (ms a call; wall by CUDA events, device by the profiler; bound from the "
        "H100's published peaks): " + "; ".join(times))
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
    mean = torch.tensor(ke.PIXEL_MEAN, device=dev)
    shapes = {}
    for frames, hw in ((native, (H, W)), (net, PYRAMID_HW[0]), (net, PYRAMID_HW[1])):
        batch = frames[:DETECT_B]

        def library(batch=batch, hw=hw):  # the same half-pixel bilinear resize, then the mean
            x = F.interpolate(batch.permute(0, 3, 1, 2).float(), size=hw, mode="bilinear",
                              align_corners=False)
            return x.permute(0, 2, 3, 1) - mean

        label = f"{batch.shape[1]}x{batch.shape[2]}->{hw[0]}x{hw[1]}"
        lib_err = float((library() - ke.fused_resize_normalize(batch, hw)).abs().max())
        t = kernel_times(lambda: ke.fused_resize_normalize_kernel(batch, hw),
                         "resize_normalize_kernel", iters=50)
        t["library_ms"] = cuda_ms(library, iters=20)
        t["library_device_ms"] = device_ms(library, 20)[0]
        n_out = batch.shape[0] * hw[0] * hw[1] * 3
        # per output value: two taps per source column (2 mul + add, twice), the
        # column blend (2 mul + add), the mean and the scale (2)
        t["bound_ms"], t["bound_by"] = bound(batch.numel() + n_out * 4, 11 * n_out)
        log(f"kernel resize_normalize {tuple(batch.shape)} -> {hw}: {fmt_times(t)}; bound "
            f"{t['bound_ms']:.6f} ms; library (F.interpolate + mean) wall "
            f"{t['library_ms']:.4f} ms, device {t['library_device_ms']:.5f} ms (library vs "
            f"plain max |diff| {lib_err:.2e})")
        if not shapes:  # the record's own figures: the device-resize call
            main, batch_main, hw_main = t, batch, hw
        shapes[label] = {k: t[k] for k in ("ms", "device_ms", "host_us", "bound_ms", "library_ms",
                                           "library_device_ms")}
    plain_ms = cuda_ms(lambda: ke.fused_resize_normalize(batch_main, hw_main), iters=20)
    times.append(f"resize_normalize kernel {main['ms']:.4f} device {main['device_ms']:.5f} plain "
                 f"{plain_ms:.4f} library {main['library_ms']:.4f} (device "
                 f"{main['library_device_ms']:.5f}) bound {main['bound_ms']:.6f} "
                 f"({tuple(batch_main.shape)} -> {hw_main})")
    return dict(name="resize_normalize", route="cuda",
                source="vdetlib_tpu_torch/csrc/resize_normalize.cu",
                replaces="vdetlib_tpu/kernels/preprocess.py:60", max_abs_err=err, ms=main["ms"],
                device_ms=main["device_ms"], host_us=main["host_us"], plain_ms=plain_ms,
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=main["library_ms"],
                library_device_ms=main["library_device_ms"], shapes=shapes)


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
    t = kernel_times(lambda: kf.track_scan_kernel(*args), "track_scan_kernel", iters=10)
    ms = t["ms"]
    plain_ms = cuda_ms(lambda: kf.track_scan_plain(*args), iters=2, warmup=1)
    f, ats, _, tpl, _, _ = args
    Q, P, Cf = cfg.search_pool, cfg.template_pool, f.shape[-1]
    regs, spill = ptxas_usage(build.build_log("track_scan"),
                              f"track_scan_kernelI13__nv_bfloat16Lb1ELi{Q}ELi{P}ELi{Cf}E")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_cta = kf.cluster_ctas(A, sms)
    log(f"kernel track_scan round: {fmt_times(t)}, device {t['device_ms'] * 1e3 / Ts:.2f} us a "
        f"step; {n_cta} blocks a "
        f"lane ({2 * A * n_cta} of {sms} SMs), "
        f"{kf._smem_bytes(Q, P, Cf, True, kf.launch_parts(Q, P, Cf, True))} bytes of dynamic "
        f"shared memory a block; ptxas: {regs} registers, {spill} bytes spilled (bf16, Q={Q}, "
        f"P={P}, C={Cf} compiled in)")
    n_pos, n_live = scan_work(f, ats.cpu().numpy(), want, cfg)
    n_bytes = (n_pos * Cf * f.element_size() + tpl.numel() * 4 + A * 4 * 4
               + 2 * Ts * A * (4 * 4 + 4 + 1))
    b_ms, b_by = bound(n_bytes, n_live * scan_ops(Q, P, Cf))
    times.append(f"track_scan kernel {ms:.4f} device {t['device_ms']:.5f} plain {plain_ms:.4f} "
                 f"bound {b_ms:.6f} "
                 f"({Ts} steps x {2 * A} lanes over {tuple(f.shape)}: {n_live} lane-steps "
                 f"track, reading {n_pos} of {Ts * f.shape[1] * f.shape[2]} feature positions, "
                 f"{n_bytes / 1e6:.2f} MB)")
    return dict(name="track_scan", route="cuda", source="vdetlib_tpu_torch/csrc/track_scan.cu",
                replaces="vdetlib_tpu/kernels/track_pallas.py:230",
                max_abs_err=max(step_box, step_peak), ms=ms, device_ms=t["device_ms"],
                host_us=t["host_us"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---------------------------------------------------------------- phase 4


def tiny_models(dev, seed=0, **trk_kw):
    """The tiny preset (C=4) and the tracker in float32, seeded, on ``dev``;
    ``trk_kw`` sets other ``TrackerConfig`` fields (EMA templates, scales)."""
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset("tiny", num_classes=4, dtype=torch.float32),
                        torch.Generator().manual_seed(seed), device=dev)
    det.head.dtype = det.head.fc0.dtype = torch.float32
    with torch.no_grad():
        det.head.bbox.weight.mul_(0.1)  # a trained regressor's delta scale
    trk_cfg = TrackerConfig(dtype=torch.float32, **trk_kw)
    trk = init_tracker(trk_cfg, torch.Generator().manual_seed(seed + 1), device=dev)
    return det, trk, trk_cfg


def tiny_pipeline(dev, seed=0, trk_kw=None, **kw):
    """The tiny fused pipeline at 96×128 in float32 (detector and tracker) on
    ``dev``; ``kw`` sets other ``FusedConfig`` fields, ``trk_kw`` other
    ``TrackerConfig`` fields."""
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig, make_fused_pipeline

    det, trk, trk_cfg = tiny_models(dev, seed, **(trk_kw or {}))
    cfg = FusedConfig(**{**dict(image_hw=(96, 128), detect_batch=8, feat_batch=8,
                                anchors_per_round=4, max_tracks=8, max_paths=16, det_budget=24,
                                out_budget=24, score_thresh=0.2, anchor_thresh=0.26), **kw})
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


def tiny_stream(dev, frames, rois, trk_kw=None, **kw):
    """The tiny float32 stream (chunk 8, 16 proposals, 6 slots) on ``dev``;
    ``kw`` sets other ``StreamOptions`` (the engine, the track stride),
    ``trk_kw`` other ``TrackerConfig`` fields."""
    from vdetlib_tpu_torch.video.stream import StreamOptions, stream_video

    det, trk, trk_cfg = tiny_models(dev, **(trk_kw or {}))
    opts = StreamOptions(chunk=8, max_rois=16, num_classes=4, track_slots=6, seed_thresh=0.26,
                         max_paths=20, **kw)
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

    # mgp_window 4 at the default 64-detection budget: the dedup's 64 x 9 =
    # 576 slots are above kernel B's 512, so nms_grouped takes the sort-free
    # fixpoint in torch ops on the card (as JAX takes its XLA fixpoint)
    from vdetlib_tpu_torch.kernels.nms_grouped import nms_grouped_kernel

    kw = dict(mgp_window=4, det_budget=64)
    with torch.no_grad():
        want = tiny_pipeline("cpu", **kw)(*(torch.from_numpy(a) for a in (frames, rois)), None,
                                          torch.from_numpy(roi_mask))
        before = nms_grouped_kernel.launches
        got = tiny_pipeline(dev, **kw)(*(torch.from_numpy(a).to(dev) for a in (frames, rois)),
                                       None, torch.from_numpy(roi_mask).to(dev))
    torch.cuda.synchronize()
    assert nms_grouped_kernel.launches == before, "kernel B launched above its 512 slots"
    worst = compare_outputs(got, want)
    assert int(want.n_tracks) >= 1 and bool(want.det_mask.any())
    log(f"reference: tiny f32 pipeline at mgp_window 4 (576 dedup slots, no B launch) on {dev} "
        f"== CPU within bounds (worst float diff {worst:.6f}, n_tracks {int(want.n_tracks)})")

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

    # the host engine at track_stride 2 over the same 12 frames: a full
    # chunk of 8, then a partial chunk of 4 that computes the boundary fill
    # of frame 7 (which emits nothing here: no slot is alive before the first
    # chunk's seeds, and phase 9 checks emitted fills at the tool's defaults)
    kw = dict(engine="host", track_stride=2)
    want = tiny_stream("cpu", frames, rois, **kw)
    got = tiny_stream(dev, frames, rois, **kw)
    worst = compare_streams(got, want)
    assert len(want["tracks"]) >= 1 and (want["path_ids"] >= 0).any()
    log(f"reference: tiny f32 stream, host engine at track_stride 2, on {dev} == CPU within "
        f"bounds (worst float diff {worst:.6f}, {len(want['tracks'])} tracks)")


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
    launches = read_counts(kernels, "fused slice",
                           ("flow_level", "nms_grouped", "track_scan", "seq_nms"))
    peak = torch.cuda.max_memory_allocated()
    steady = sum(VIDEO_LENGTHS[1:]) / sum(times[1:])
    log(f"slice: {n_frames} frames in {sum(times):.3f} s = {n_frames / sum(times):.2f} frames/s "
        f"(after the first video: {steady:.2f} frames/s); peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if profile_dir:
        profile_one(lambda: pipe(*[torch.from_numpy(a).to(dev) for a in videos[-1][:2]],
                                 videos[-1][2], torch.from_numpy(videos[-1][3]).to(dev)),
                    profile_dir, "profile.txt", "fused.")
    # phase 10 rebuilds the models from their seeds: none stays on the card
    return launches, n_frames / sum(times), steady, peak, {"cfg": pipe.cfg, "videos": videos,
                                                           "walls": times}


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


def stream_runs(models, videos, opts):
    """``stream_video`` at ``opts`` over each of ``videos`` ((frames, rois,
    frame ids)), timed: a list of (result, wall s, ms of each chunk, ms after
    the last chunk: seq-NMS)."""
    from vdetlib_tpu_torch.video.stream import stream_video

    det, trk, trk_cfg = models

    def chunks(frames, marks):
        for s in range(0, len(frames), opts.chunk):
            marks.append(time.perf_counter())
            yield frames[s:s + opts.chunk]
        marks.append(time.perf_counter())  # the last chunk is done

    runs = []
    for frames, rois, _ in videos:
        marks = []
        t0 = time.perf_counter()
        res = stream_video(det, trk, trk_cfg, chunks(frames, marks), rois, opts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs.append((res, dt, np.diff(marks) * 1e3, (t0 + dt - marks[-1]) * 1e3))
    return runs


def stream_rates(runs, videos, chunk):
    """(frames/s, frames/s after the first video's first chunk, median ms
    of a full chunk after each video's first)."""
    n_frames = sum(len(v[0]) for v in videos)
    wall = sum(r[1] for r in runs)
    first_chunk = runs[0][2][0] / 1e3
    full = [x for (_, _, per_chunk, _), v in zip(runs, videos)
            for x in per_chunk[1:len(v[0]) // chunk]]
    return n_frames / wall, (n_frames - chunk) / (wall - first_chunk), float(np.median(full))


def phase_stream(dev, kernels, models, opts, profile_dir=None):
    """The stream engine at ``opts`` over two synthetic videos. Returns the
    launches, rates and peak memory, and the phase's videos, calibrated
    options and runs for phase 9."""
    from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_batch
    from vdetlib_tpu_torch.video.stream import stream_to_protos, stream_video

    det, trk, trk_cfg = models
    videos = []
    for i, T in enumerate(STREAM_LENGTHS):
        sv = synth(T, seed=10 + i)
        videos.append((sv.frames, make_rois(T, seed=10 + i, r=opts.max_rois), sv.frame_ids))
    thresh = calibrated_seed_thresh(det, dev, [v[:2] for v in videos], opts.seed_thresh,
                                    opts.chunk)
    opts = dataclasses.replace(opts, seed_thresh=thresh)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    plain_calls = seq_nms_batch.plain_calls
    runs = stream_runs(models, videos, opts)
    for i, ((frames, _, fids), (res, dt, per_chunk, tail_ms)) in enumerate(zip(videos, runs)):
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
            f"{tail_ms:.1f} ms), {len(res['tracks'])} tracks, "
            f"{int(res['keep'].sum())} kept, proto dets {len(det_proto['detections'])}, "
            f"tubelets {len(tubelets['tracks'])}, online tracks {len(track_proto['tracks'])}")
    launches = read_counts(kernels, "stream", ("flow_level", "nms_grouped", "nms_batched"))
    # the video-end linking of 3 x max_rois slots a frame keeps the tensor route
    assert launches["seq_nms"] == 0 and seq_nms_batch.plain_calls == plain_calls + len(videos), \
        "the stream's video-end seq-NMS left the plain version"
    peak = torch.cuda.max_memory_allocated()
    n_frames = sum(len(v[0]) for v in videos)
    fps, steady, med = stream_rates(runs, videos, opts.chunk)
    log(f"stream: {n_frames} frames in {sum(r[1] for r in runs):.3f} s = {fps:.2f} frames/s "
        f"(after the first chunk: {steady:.2f} frames/s); full chunk of {opts.chunk} frames: "
        f"median {med:.1f} ms ({opts.chunk / med * 1e3:.2f} frames/s); peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if profile_dir:
        frames, rois, _ = videos[-1]
        profile_one(lambda: stream_video(det, trk, trk_cfg,
                                         (frames[s:s + opts.chunk]
                                          for s in range(0, len(frames), opts.chunk)),
                                         rois, opts),
                    profile_dir, "profile_stream.txt", "stream.")
    return launches, fps, steady, med, peak, dict(videos=videos, opts=opts, runs=runs)


# ---------------------------------------------------------------- phase 9


def stream_difference(a, b):
    """None where two stream results are equal as the JAX engine-parity
    tests require (keep, boxes, scores, path ids and seq-scores array-equal;
    every segment's frames, boxes and scores equal), else what differs."""
    if a["num_frames"] != b["num_frames"]:
        return "num_frames"
    for k in ("keep", "boxes", "scores", "path_ids", "seq_scores"):
        if not np.array_equal(a[k], b[k]):
            return k
    if set(a["tracks"]) != set(b["tracks"]):
        return "track ids"
    for tid, sa in a["tracks"].items():
        sb = b["tracks"][tid]
        if [e[0] for e in sa] != [e[0] for e in sb]:
            return f"track {tid} frames"
        if not np.array_equal(np.stack([e[1] for e in sa]), np.stack([e[1] for e in sb])):
            return f"track {tid} boxes"
        if [e[2] for e in sa] != [e[2] for e in sb]:
            return f"track {tid} scores"
    return None


@contextlib.contextmanager
def seed_spy(seeds):
    """Appends (t_global // chunk, global seed frame) of every seed the
    engines hand to their shared bookkeeping to ``seeds``."""
    from vdetlib_tpu_torch.video import stream as st

    add = st._TrackBook.add_chunk

    def spy(self, out, chunk_seeds, Tc, t_global):
        seeds.extend((t_global // self.opts.chunk, t_global + ti) for _, ti, _, _ in chunk_seeds)
        return add(self, out, chunk_seeds, Tc, t_global)

    st._TrackBook.add_chunk = spy
    try:
        yield seeds
    finally:
        st._TrackBook.add_chunk = add


def locate_divergence(models, video, opts):
    """Both engines over ``video`` again, each chunk's stage outputs recorded
    (detection + MGP, slot advance, seeds, backtrack), in the manner of
    scripts/torch_stream_divergence.py: the first chunk and stage where the
    engines differ, with the largest difference there."""
    from vdetlib_tpu_torch.video import stream as st

    saved = st._detect_stage, st._track_stage, st._TrackBook.add_chunk
    recs = {}

    def recorders(chunks):
        def detect(*a):
            out = saved[0](*a)
            chunks.append({"detect + MGP": [x.cpu().numpy() for x in out[:3]]})
            return out

        def track(*a):
            out = saved[1](*a)
            chunks[-1]["slot advance"] = [x.cpu().numpy() for x in out[1:4] + out[8:]]
            return out

        def add(self, out, seeds, Tc, t_global):
            chunks[-1]["seeds"] = [np.array([a, ti, *box, sc], np.float64)
                                   for a, ti, box, sc in seeds]
            chunks[-1]["backtrack"] = [np.concatenate([out["bb"][a].ravel(),
                                                       out["balive"][a] > 0.5])
                                       for a, _, _, _ in seeds] if opts.backtrack else []
            return saved[2](self, out, seeds, Tc, t_global)
        return detect, track, add

    frames, rois, _ = video
    try:
        for engine in ("fused", "host"):
            st._detect_stage, st._track_stage, st._TrackBook.add_chunk = recorders(
                recs.setdefault(engine, []))
            st.stream_video(*models, (frames[s:s + opts.chunk]
                                      for s in range(0, len(frames), opts.chunk)),
                            rois, dataclasses.replace(opts, engine=engine))
    finally:
        st._detect_stage, st._track_stage, st._TrackBook.add_chunk = saved
    for k, (f, h) in enumerate(zip(recs["fused"], recs["host"])):
        for stage in f:
            a, b = f[stage], h[stage]
            if len(a) != len(b):
                return f"chunk {k}, stage {stage}: {len(a)} against {len(b)} entries"
            for x, y in zip(a, b):
                x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
                if x.shape != y.shape or not np.array_equal(x, y):
                    err = np.abs(x - y).max() if x.shape == y.shape else "shape"
                    return f"chunk {k}, stage {stage}: max |diff| {err}"
    return "no stage of any chunk differs (the bookkeeping or seq-NMS does)"


def stream_spans(models, video, opts):
    """The fused step over the full chunks of ``video`` under torch.profiler
    (after one untraced pass): {span: (host ms, device ms)} of the stream's
    spans over those chunks."""
    from torch.profiler import ProfilerActivity, profile

    from vdetlib_tpu_torch.video.stream import init_carry, make_stream_chunk_fn

    det, trk, trk_cfg = models
    dev = next(det.parameters()).device
    step, _ = make_stream_chunk_fn(det, trk, trk_cfg, opts)
    frames, rois, _ = video

    def run():
        carry, halo = init_carry(opts, trk_cfg, dev), None
        for s in range(0, len(frames) - opts.chunk + 1, opts.chunk):
            f = torch.from_numpy(np.ascontiguousarray(frames[s:s + opts.chunk])).to(dev)
            halo = f[0] if halo is None else halo
            carry, halo, packed = step(f, torch.from_numpy(rois[s:s + opts.chunk]).to(dev),
                                       opts.chunk, halo, carry)
            packed.cpu()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # the host-side span events (the profiler also lists each span on the
    # device's timeline under the same name, with no host time)
    return {e.key: (e.cpu_time_total / 1e3, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith("stream.") and e.cpu_time_total > 0}


def phase_stream_engines(kernels, models, ctx):
    """Phase 9: the host engine and track_stride 2 on phase 6's videos and
    calibrated options. (a) host at stride 1 == phase 6's fused results; (b)
    fused == host at stride 2; (c) both again at strides 1 and 2 on the
    100-frame video with conf_thresh raised to the median of its track
    confidences in phase 6, so that tracks die and slots are seeded again in
    later chunks. Returns the host engine's kernel launches of (a)
    and (b), counted apart from phases 5-8."""
    videos, opts = ctx["videos"], ctx["opts"]
    runs = {("fused", 1): ctx["runs"]}
    seeds = {}
    torch.cuda.synchronize()
    zero_counts(kernels)
    for engine, stride in (("host", 1), ("host", 2)):
        with seed_spy(seeds.setdefault((engine, stride), [])):
            runs[(engine, stride)] = stream_runs(
                models, videos, dataclasses.replace(opts, engine=engine, track_stride=stride))
    launches = read_counts(kernels, "stream host engine (phase 9)",
                           ("flow_level", "nms_grouped", "nms_batched"))
    runs[("fused", 2)] = stream_runs(models, videos, dataclasses.replace(opts, track_stride=2))
    for (engine, stride), r in runs.items():
        fps, steady, med = stream_rates(r, videos, opts.chunk)
        log(f"stream {engine} engine, track_stride {stride}: {fps:.2f} frames/s (after the first "
            f"chunk {steady:.2f}); full chunk of {opts.chunk} frames: median {med:.1f} ms "
            f"({opts.chunk / med * 1e3:.2f} frames/s); seq-NMS and protos "
            f"{[round(float(x[3]), 1) for x in r]} ms")
    for stride in (1, 2):
        log(f"stream seeds, host engine, track_stride {stride}, both videos: (chunk, frame) "
            f"{seeds[('host', stride)]}")

    def same(vids, rs_f, rs_h, opts_x):
        for i, ((f, *_), (h, *_), video) in enumerate(zip(rs_f, rs_h, vids)):
            diff = stream_difference(f, h)
            if diff is not None:
                where = locate_divergence(models, video, opts_x)
                raise AssertionError(f"stream engines differ at track_stride "
                                     f"{opts_x.track_stride} on video {i} ({diff}); first "
                                     f"difference: {where}")

    same(videos, runs[("fused", 1)], runs[("host", 1)], opts)
    same(videos, runs[("fused", 2)], runs[("host", 2)], dataclasses.replace(opts, track_stride=2))

    # preconditions: the cases the comparison must cover
    C_ = opts.chunk
    for stride in (1, 2):
        for (res, *_), (frames, _, _) in zip(runs[("host", stride)], videos):
            segs = list(res["tracks"].values())
            assert any(min(e[0] for e in s) // C_ != max(e[0] for e in s) // C_ for s in segs), \
                f"no track crosses a chunk boundary at track_stride {stride}"
            assert any(e[2] == 0.0 for s in segs for e in s), \
                f"no backtracked entries at track_stride {stride}"
    seed_frames = {t for _, t in seeds[("host", 2)]}
    for (res, *_), (frames, _, _) in zip(runs[("host", 2)], videos):
        fills = [e[0] for s in res["tracks"].values() for e in s
                 if e[0] % C_ == C_ - 1 and e[0] < len(frames) - 1 and e[2] != 0.0
                 and e[0] not in seed_frames]
        assert fills, "no boundary-fill entries at a chunk's last frame at track_stride 2"
    for (r1, *_), (r2, *_), (rf, *_) in zip(runs[("fused", 1)], runs[("host", 2)],
                                             runs[("fused", 2)]):
        assert np.array_equal(r1["boxes"], r2["boxes"]) and np.array_equal(r1["boxes"],
                                                                          rf["boxes"]), \
            "detection boxes depend on the track stride"
    log(f"stream engines: host == fused bit for bit at track_stride 1 (against phase 6) and 2, "
        f"{len(videos)} videos; boundary fills, backtracked entries and tracks across chunks "
        f"present; detection boxes equal at both strides")

    # (c) tracks that die: the slots are seeded again in later chunks
    # a track of phase 6 whose confidence falls below this threshold dies
    # here, in a chunk after its first, and frees its slot for a seed there
    confs = [e[2] for s in ctx["runs"][-1][0]["tracks"].values() for e in s if e[2] != 0.0]
    opts_c = dataclasses.replace(opts, conf_thresh=float(np.median(confs)))
    for stride in (1, 2):
        opts_s = dataclasses.replace(opts_c, track_stride=stride)
        rc = {"fused": stream_runs(models, videos[-1:], opts_s)}
        with seed_spy([]) as sc:
            rc["host"] = stream_runs(models, videos[-1:],
                                     dataclasses.replace(opts_s, engine="host"))
        same(videos[-1:], rc["fused"], rc["host"], opts_s)
        chunks_seeded = sorted({k for k, _ in sc})
        assert len(chunks_seeded) >= 2, f"seeds in chunks {chunks_seeded} only"
        log(f"stream engines with conf_thresh {opts_c.conf_thresh:.6f} (the median of the "
            f"video's track confidences in phase 6), track_stride {stride}: host == fused bit "
            f"for bit; "
            f"{len(sc)} seeds in chunks {chunks_seeded}, "
            f"{len(rc['host'][0][0]['tracks'])} tracks")

    spans = {s: stream_spans(models, videos[0], dataclasses.replace(opts, track_stride=s))
             for s in (1, 2)}
    for name in ("stream.track_features", "stream.track_chunk"):
        log(f"span {name} over the {len(videos[0][0]) // C_} full chunks of stream video 0 "
            f"(fused engine; host / device ms): track_stride 1 "
            f"{spans[1][name][0]:.3f} / {spans[1][name][1]:.3f}, track_stride 2 "
            f"{spans[2][name][0]:.3f} / {spans[2][name][1]:.3f}")
    return launches


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
    for max_boxes, kernel in ((512, "nms_sorted"), (1024, "nms_sorted"), (128, "nms_batched")):
        vid, det = frame_nms_protos(NMS_FRAMES, max_boxes, seed=max_boxes)
        if max_boxes > 512:  # past D's old limit: the frames must hold more than 512
            per_frame = np.bincount([d["frame"] for d in det["detections"]])
            assert per_frame.max() > 512, "no frame holds more than 512 detections"
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
        if max_boxes in (128, 512):  # the Jacobi form launches no hand kernel
            torch.cuda.reset_peak_memory_stats()
            t3 = time.perf_counter()
            fixed = frame_nms(vid, det, thresh=0.3, backend="fixpoint", max_boxes=max_boxes,
                              device=dev)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            assert fixed == want, f"frame_nms fixpoint at max_boxes {max_boxes} differs from host"
            log(f"frame_nms fixpoint == host at {max_boxes} boxes: {(t4 - t3) * 1e3:.1f} ms wall, "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
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
    return launches, {"vid": vid, "det": det_proto, "track": track}


# ---------------------------------------------------------------- phase 10


def sweep_config(fcfg):
    """The ``PipelineConfig`` whose fused config is ``fcfg`` (phase 5's)."""
    from vdetlib_tpu_torch.pipeline.fused_runner import fused_config_from_pipeline
    from vdetlib_tpu_torch.pipeline.runner import PipelineConfig
    from vdetlib_tpu_torch.video.detect import DetectOptions
    from vdetlib_tpu_torch.video.link import LinkOptions
    from vdetlib_tpu_torch.video.mgp import MGPOptions
    from vdetlib_tpu_torch.video.rescore import RescoreOptions
    from vdetlib_tpu_torch.video.track import TrackOptions
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig

    cfg = PipelineConfig(
        detect=DetectOptions(batch_size=fcfg.detect_batch, max_rois=R, image_hw=(H, W)),
        mgp=MGPOptions(num_classes=C, image_hw=(H, W)),
        track=TrackOptions(max_tracks=fcfg.max_tracks, anchors_per_round=fcfg.anchors_per_round,
                           anchor_thresh=fcfg.anchor_thresh, batch_size=fcfg.feat_batch,
                           image_hw=(H, W)),
        tracker_cfg=TrackerConfig(),
        rescore=RescoreOptions(num_classes=C),
        link=LinkOptions(num_classes=C, max_paths=fcfg.max_paths),
    )
    assert fused_config_from_pipeline(cfg) == fcfg, "the sweep's config is not phase 5's"
    return cfg


def sweep_entries(videos):
    """Phase 5's videos as ``run_videos_fused`` entries: (vid_proto, box_proto,
    frames in memory), each holding R proposals a frame."""
    from vdetlib_tpu_torch.data.synth import vid_proto_in_memory

    entries = []
    for i, (frames, rois, t_valid, roi_mask, fids) in enumerate(videos):
        assert roi_mask[:t_valid].all()
        sv = dataclasses.replace(synth(t_valid, i), video=f"synth{i:03d}")
        assert list(sv.frame_ids) == list(fids) and np.array_equal(sv.frames, frames[:t_valid])
        entries.append((vid_proto_in_memory(sv), staged_box_proto(rois[:t_valid], sv),
                        frames[:t_valid]))
    return entries


def direct_protos(pipe, dev, videos, names, min_score, out_dir):
    """``fused_to_protos`` of direct pipeline calls, trimmed to the real frames
    as the sweep does, written as the sweep writes them; returns the seconds
    spent in the pipeline (synchronised), in ``fused_to_protos`` and in the
    writes, summed over the videos."""
    import os

    from vdetlib_tpu_torch.pipeline.fused import fused_to_protos
    from vdetlib_tpu_torch.protos import proto_dump

    spent = np.zeros(3)
    for (frames, rois, t_valid, roi_mask, fids), name in zip(videos, names):
        args = [torch.from_numpy(a).to(dev) for a in (frames, rois, roi_mask)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(args[0], args[1], t_valid, args[2])
        out = out._replace(det_boxes=out.det_boxes[:t_valid], det_scores=out.det_scores[:t_valid],
                           det_mask=out.det_mask[:t_valid],
                           final_scores=out.final_scores[:, :t_valid],
                           path_ids=out.path_ids[:, :t_valid])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        det_proto, tubelets = fused_to_protos(out, fids, name, min_score=min_score)
        t2 = time.perf_counter()
        proto_dump(det_proto, os.path.join(out_dir, name, "final.json"))
        proto_dump(tubelets, os.path.join(out_dir, name, "tubelets.json"))
        spent += (t1 - t0, t2 - t1, time.perf_counter() - t2)
    return spent


def file_bytes(results):
    import pathlib

    return [{k: pathlib.Path(r[k]).read_bytes() for k in ("final", "tubelets")} for r in results]


def phase_sweep(dev, kernels, ctx, slice_fps, card, ckpt_dir):
    """Phase 10: checkpoints of phase 5's models (drawn again from their
    seeds) saved into ``ckpt_dir``, then ``run_videos_fused`` over phase 5's
    videos with the loaded models; returns the sweep's kernel launches,
    counted apart from phases 5-9, and for phases 12 and 15 the loaded
    models, the entries, the calibrated ``anchor_thresh``, the sweep's
    frames/s and the checkpoints' paths."""
    import os
    import tempfile

    from vdetlib_tpu_torch.pipeline.checkpoint import load_params, save_params
    from vdetlib_tpu_torch.pipeline.fused import make_fused_pipeline
    from vdetlib_tpu_torch.pipeline.fused_runner import run_videos_fused
    from vdetlib_tpu_torch.pipeline.runner import Models

    videos = ctx["videos"]
    pipe = make_fused_pipeline(*base_models(dev), ctx["cfg"])
    cfg = sweep_config(pipe.cfg)
    with tempfile.TemporaryDirectory() as tmp:
        # checkpoints: into models drawn from other seeds, on the card
        paths = {"detector": os.path.join(ckpt_dir, "detector.pt"),
                 "tracker": os.path.join(ckpt_dir, "tracker.pt")}
        save_params(paths["detector"], pipe.det_model)
        save_params(paths["tracker"], pipe.trk_model)
        det, trk, _ = base_models(dev, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_params(paths["detector"], det)
        load_params(paths["tracker"], trk)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        for name, a, b in (("detector", pipe.det_model, det), ("tracker", pipe.trk_model, trk)):
            sa, sb = a.state_dict(), b.state_dict()
            assert sorted(sa) == sorted(sb)
            for k in sa:
                assert sb[k].device == sa[k].device and sb[k].dtype == sa[k].dtype \
                    and torch.equal(sb[k], sa[k]), f"{name} checkpoint: {k} differs"
        log(f"checkpoints: detector {os.path.getsize(paths['detector'])} bytes "
            f"({len(det.state_dict())} tensors), tracker {os.path.getsize(paths['tracker'])} "
            f"bytes ({len(trk.state_dict())} tensors); both loaded onto the card in "
            f"{load_s * 1e3:.1f} ms; every tensor equal bit for bit")

        # the sweep, with the loaded models
        models = Models(det, trk)
        entries = sweep_entries(videos)
        names = [e[0]["video"] for e in entries]
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        os.environ["VDETLIB_TPU_METRICS"] = metrics_path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        g1 = run_videos_fused(os.path.join(tmp, "g1"), entries, models, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kernels, "fused sweep (phase 10)",
                               ("flow_level", "nms_grouped", "track_scan"))
        peak = torch.cuda.max_memory_allocated()
        del os.environ["VDETLIB_TPU_METRICS"]
        with open(metrics_path) as f:
            record = [json.loads(line) for line in f][-1]
        assert record["stage"] == "pipeline_fused" and record["frames"] == sum(VIDEO_LENGTHS)
        assert not any(r.get("error") for r in g1)

        direct_dir = os.path.join(tmp, "direct")
        spent = direct_protos(pipe, dev, videos, names, cfg.link.min_score, direct_dir)
        want = file_bytes([{k: os.path.join(direct_dir, n, f"{k}.json")
                            for k in ("final", "tubelets")} for n in names])
        got = file_bytes(g1)
        for name, w, g in zip(names, want, got):
            for k in ("final", "tubelets"):
                assert g[k] == w[k], f"sweep {name}/{k}.json differs from the direct pipeline's"
        n_dets = [len(json.loads(g["final"])["detections"]) for g in got]
        n_tubes = [len(json.loads(g["tubelets"])["tracks"]) for g in got]
        assert min(n_dets) > 0 and min(n_tubes) > 0
        log(f"sweep == direct pipeline + fused_to_protos, byte for byte, {len(names)} videos "
            f"(final dets {n_dets}, tubelets {n_tubes})")

        # grouping, resume, keep_going
        g2 = run_videos_fused(os.path.join(tmp, "g2"), entries, models, cfg, group_size=2)
        assert file_bytes(g2) == got, "group_size 2 differs from group_size 1"
        stamps = [os.stat(r[k]).st_mtime_ns for r in g1 for k in ("final", "tubelets")]
        again = run_videos_fused(os.path.join(tmp, "g1"), entries, models, cfg)
        assert [os.stat(r[k]).st_mtime_ns for r in again for k in ("final", "tubelets")] \
            == stamps, "a resumed sweep rewrote an output"
        bad = dict(entries[0][0], video="synth_nobox")
        sweep4 = entries + [(bad, None, entries[0][2])]
        kg = run_videos_fused(os.path.join(tmp, "kg"), sweep4, models, cfg, keep_going=True)
        assert "box_proto" in kg[3].get("error", "") and not os.path.exists(kg[3]["final"])
        assert file_bytes(kg[:3]) == got, "keep_going changed the other videos"
        try:
            run_videos_fused(os.path.join(tmp, "kg"), sweep4, models, cfg)
        except ValueError as e:
            assert "box_proto" in str(e)
        else:
            raise AssertionError("a video without proposals did not stop the sweep")
        log("sweep: group_size 2 == 1 byte for byte; the resumed sweep wrote nothing; "
            "keep_going marked the entry without proposals failed and completed the other "
            "three; without keep_going it raised")

    fps = sum(VIDEO_LENGTHS) / wall
    ctx12 = {"models": models, "entries": entries, "anchor_thresh": cfg.track.anchor_thresh,
             "fps": fps, "checkpoints": paths}
    log(f"sweep on {card}: {sum(VIDEO_LENGTHS)} frames in {wall:.3f} s = {fps:.2f} frames/s "
        f"(run_videos_fused: load, upload, pipeline, protos), against phase 5's pipeline-only "
        f"{slice_fps:.2f} frames/s; prefetch wait {record['prefetch_wait_s']:.4f} s; peak "
        f"device memory {peak / 2**20:.1f} MiB; the direct calls' {sum(spent):.3f} s: pipeline "
        f"{spent[0]:.3f} s, fused_to_protos {spent[1]:.3f} s, proto writes {spent[2]:.3f} s")
    return launches, ctx12


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 11


def timed(walls, name, fn, peaks=None):
    """``fn()`` timed on the host clock between two synchronisations; with
    ``peaks`` also its peak device memory."""
    torch.cuda.synchronize()
    if peaks is not None:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    if peaks is not None:
        peaks[name] = torch.cuda.max_memory_allocated()
    return out


def compare_det_protos(name, got, want, b_tol=0.5, s_tol=0.01):
    """The same (frame, classes) entry sequence; boxes within ``b_tol`` px and
    scores within ``s_tol``. Returns the worst (box, score) differences."""
    g, w = got["detections"], want["detections"]
    assert len(g) == len(w) > 0, f"{name}: {len(g)} entries against {len(w)}"
    assert [(d["frame"], [e["class_index"] for e in d["scores"]]) for d in g] == \
        [(d["frame"], [e["class_index"] for e in d["scores"]]) for d in w], \
        f"{name}: the (frame, class) entries differ"
    gb, wb = np.array([d["bbox"] for d in g]), np.array([d["bbox"] for d in w])
    gs = np.array([e["score"] for d in g for e in d["scores"]])
    ws = np.array([e["score"] for d in w for e in d["scores"]])
    assert np.isfinite(gb).all() and np.isfinite(gs).all(), f"{name}: non-finite"
    db, ds = float(np.abs(gb - wb).max()), float(np.abs(gs - ws).max())
    assert db <= b_tol and ds <= s_tol, f"{name}: boxes differ by {db}, scores by {ds}"
    return db, ds


def compare_tubelets(name, got, want, s_tol=0.01):
    """Seq-NMS tubelets: the same paths (each track's frames, class and
    boxes), scores within ``s_tol``. Returns the worst score difference."""
    assert len(got["tracks"]) == len(want["tracks"]) > 0, f"{name}: tubelet counts differ"
    ds = 0.0
    for a, b in zip(got["tracks"], want["tracks"]):
        assert [(e["frame"], e["class_index"], e["bbox"]) for e in a] == \
            [(e["frame"], e["class_index"], e["bbox"]) for e in b], f"{name}: paths differ"
        ds = max(ds, max(abs(x["score"] - y["score"]) for x, y in zip(a, b)))
    assert ds <= s_tol, f"{name}: tubelet scores differ by {ds}"
    return ds


def phase_staged_chain(dev, kernels, ctx, flow_rec):
    """The staged chain after phase 8's detect → track, at the tools'
    defaults with phase 8's base detector (rebuilt from its seed) over its 96
    native 360×480 frames, in memory: ``mgp`` (window 1, "fastest", host
    dedup: kernel A twice), ``perturb_rescore_track_proto`` (8
    perturbations, seed 0, 32 frames a batch) on phase 8's track_proto,
    ``tubelet_rescore`` and ``seq_nms_video`` with the ``device`` and the
    ``host`` backends (the same paths). Then ``mgp``, ``tubelet_rescore``
    and ``seq_nms_video`` again on the CPU, each fed the card stage's input:
    the same entries, boxes within 0.5 px, scores within 0.01, the same
    seq-NMS paths. A one-frame video through ``mgp`` launches no A and
    equals the CPU."""
    from vdetlib_tpu_torch.protos.accessors import frame_ids
    from vdetlib_tpu_torch.video.link import LinkOptions, seq_nms_video
    from vdetlib_tpu_torch.video.mgp import MGPOptions, mgp
    from vdetlib_tpu_torch.video.perturb import PerturbOptions, perturb_rescore_track_proto
    from vdetlib_tpu_torch.video.rescore import RescoreOptions, tubelet_rescore

    det_model = base_models(dev)[0]
    sv = staged_video(NATIVE_HW)
    vid, det_proto, track = ctx["vid"], ctx["det"], ctx["track"]
    fids = frame_ids(vid)
    mopts, popts, ropts, lopts = MGPOptions(), PerturbOptions(), RescoreOptions(), LinkOptions()
    assert (mopts.window, mopts.flow_preset, mopts.run_nms, mopts.num_classes) == \
        (1, "fastest", True, C)
    assert (popts.num_perturb, popts.seed) == (8, 0)

    zero_counts(kernels)
    walls, peaks = {}, {}
    mdet = timed(walls, "mgp", lambda: mgp(vid, det_proto, mopts, frames_u8=sv.frames,
                                           device=dev), peaks)
    a_mgp = kernels["flow_level"].launches
    assert a_mgp == 2, f"mgp launched kernel A {a_mgp} times, not twice"
    ptrack = timed(walls, "perturb", lambda: perturb_rescore_track_proto(
        det_model, sv.frames, track, fids, popts, batch_frames=32), peaks)
    score_proto, rdet = timed(walls, "rescore", lambda: tubelet_rescore(
        vid, mdet, ptrack, ropts, device=dev), peaks)
    ddet, dtub = timed(walls, "seq_nms device", lambda: seq_nms_video(
        vid, rdet, lopts, device=dev), peaks)
    hdet, htub = timed(walls, "seq_nms host", lambda: seq_nms_video(
        vid, rdet, dataclasses.replace(lopts, backend="host")), peaks)
    launches = read_counts(kernels, "staged chain", ("flow_level", "seq_nms"))
    assert launches["seq_nms"] == 1 and sum(launches.values()) == 3, \
        "the staged chain launched more than kernel A twice and G once (seq_nms device)"

    # what came out: MGP added copies, every live track box got perturbation
    # scores, the statistics reached the detections, seq-NMS found paths
    assert len(mdet["detections"]) > 0
    n_boxes = sum(len(t) for t in track["tracks"])
    n_pert = sum("perturb_scores" in e for t in ptrack["tracks"] for e in t)
    assert n_pert == n_boxes > 0, f"{n_pert} of {n_boxes} track boxes carry perturb_scores"
    assert all(math.isfinite(v) for t in ptrack["tracks"] for e in t
               for v in e["bbox"] + [e["perturb_scores"][0]["score"]])
    assert any(tr["scores"] for tr in score_proto["tracks"]), "no tubelet statistic"
    db_backends, ds_backends = compare_det_protos("seq_nms device vs host", ddet, hdet, 0.0, 1e-5)
    compare_tubelets("seq_nms device vs host", dtub, htub, 1e-5)

    # the CPU, fed each card stage's input
    cpu_walls = {}
    errs = {"mgp": compare_det_protos("mgp card vs CPU", mdet, timed(
        cpu_walls, "mgp", lambda: mgp(vid, det_proto, mopts, frames_u8=sv.frames, device="cpu")))}
    cpu_sp, cpu_rdet = timed(cpu_walls, "rescore",
                             lambda: tubelet_rescore(vid, mdet, ptrack, ropts, device="cpu"))
    errs["rescore"] = compare_det_protos("rescore card vs CPU", rdet, cpu_rdet)
    assert [[e["class_index"] for e in t["scores"]] for t in score_proto["tracks"]] == \
        [[e["class_index"] for e in t["scores"]] for t in cpu_sp["tracks"]]
    cpu_ddet, cpu_dtub = timed(cpu_walls, "seq_nms device",
                               lambda: seq_nms_video(vid, rdet, lopts, device="cpu"))
    errs["seq_nms"] = compare_det_protos("seq_nms card vs CPU", ddet, cpu_ddet)
    errs["tubelets"] = compare_tubelets("seq_nms card vs CPU", dtub, cpu_dtub)

    # a one-frame video: no flow pair, no launch of A
    vid1 = dict(vid, frames=vid["frames"][:1])
    det1 = dict(det_proto, detections=[d for d in det_proto["detections"]
                                       if d["frame"] == fids[0]])
    zero_counts(kernels)
    one = mgp(vid1, det1, mopts, frames_u8=sv.frames[:1], device=dev)
    assert kernels["flow_level"].launches == 0, "mgp launched kernel A on a one-frame video"
    compare_det_protos("mgp of one frame, card vs CPU", one,
                       mgp(vid1, det1, mopts, frames_u8=sv.frames[:1], device="cpu"))

    log(f"staged chain on {len(fids)} native {NATIVE_HW[0]}x{NATIVE_HW[1]} frames: det_proto "
        f"{len(det_proto['detections'])} entries → mgp {len(mdet['detections'])} → rescore "
        f"{len(rdet['detections'])} → seq_nms {len(ddet['detections'])}; {len(track['tracks'])} "
        f"tracks ({n_pert} boxes perturbed), {len(dtub['tracks'])} tubelets; seq_nms device == "
        f"host (paths identical, scores within {ds_backends:.2e})")
    log(f"staged chain wall on the card: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                                       for k, v in walls.items())
        + f"; CPU reruns: " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in cpu_walls.items())
        + f"; card vs CPU worst (box px, score): {errs}; kernel A {a_mgp} launches at "
        f"{tuple(flow_rec['mgp_shape']['shape'])} ({flow_rec['mgp_shape']['device_ms']:.5f} ms "
        f"device a launch in phase 3); peak device memory {max(peaks.values()) / 2**20:.1f} "
        f"MiB (by stage: " + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in peaks.items())
        + "); one-frame mgp: no launch, == CPU")
    return launches


# ---------------------------------------------------------------- phase 12


STAGE_FILES = ("detect", "mgp", "track", "score", "rescored", "final", "tubelets")


def staged_sweep_config(anchor_thresh):
    """The ``pipeline`` tool's stage defaults (C = 31 at 240×320) with phase
    10's calibrated ``anchor_thresh``."""
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.runner import PipelineConfig
    from vdetlib_tpu_torch.video.detect import DetectOptions
    from vdetlib_tpu_torch.video.link import LinkOptions
    from vdetlib_tpu_torch.video.mgp import MGPOptions
    from vdetlib_tpu_torch.video.rescore import RescoreOptions
    from vdetlib_tpu_torch.video.track import TrackOptions

    return PipelineConfig(
        detect=DetectOptions(batch_size=8, max_rois=32, image_hw=(H, W), score_thresh=0.05),
        mgp=MGPOptions(window=1, num_classes=C, image_hw=(H, W), flow_preset="fastest"),
        track=TrackOptions(max_tracks=16, image_hw=(H, W), anchor_thresh=anchor_thresh,
                           conf_thresh=0.5, frame_stride=2),
        tracker_cfg=TrackerConfig(),
        rescore=RescoreOptions(num_classes=C),
        link=LinkOptions(num_classes=C),
    )


def stage_bytes(workdir, names):
    """{video: {stage file: bytes}} of a staged run's files."""
    import os
    import pathlib

    return {n: {k: pathlib.Path(workdir, n, f"{k}.json").read_bytes() for k in STAGE_FILES
                if os.path.exists(os.path.join(workdir, n, f"{k}.json"))} for n in names}


def direct_staged_chain(models, cfg, entries, dev, out_dir):
    """Each entry through ``det_vid`` → ``mgp`` → ``track_from_det`` →
    ``tubelet_rescore`` → ``seq_nms_video`` called one by one, the protos
    written as the runner names them; returns each video's seconds."""
    import os

    from vdetlib_tpu_torch.protos import proto_dump
    from vdetlib_tpu_torch.video.detect import det_vid
    from vdetlib_tpu_torch.video.link import seq_nms_video
    from vdetlib_tpu_torch.video.mgp import mgp
    from vdetlib_tpu_torch.video.rescore import tubelet_rescore
    from vdetlib_tpu_torch.video.track import track_from_det

    secs = []
    for vid, box, frames in entries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = det_vid(models.detector, vid, box, cfg.detect, frames_u8=frames)
        mdet = mgp(vid, det, cfg.mgp, frames_u8=frames, device=dev)
        track = track_from_det(models.tracker, vid, mdet, cfg.tracker_cfg, cfg.track,
                               frames_u8=frames)
        score, rdet = tubelet_rescore(vid, mdet, track, cfg.rescore, device=dev)
        final, tubelets = seq_nms_video(vid, rdet, cfg.link, device=dev)
        for name, proto in (("detect", det), ("mgp", mdet), ("track", track), ("score", score),
                            ("rescored", rdet), ("tubelets", tubelets), ("final", final)):
            proto_dump(proto, os.path.join(out_dir, vid["video"], f"{name}.json"))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def matched_staged_vs_fused(dev, varying_layout, snap_weight=0.0, tubelet_boxes=False,
                            flow_preset="fast", trk_kw=None):
    """tests/test_torch_staged_runner.py's staged-vs-fused check on ``dev``:
    phase 4's tiny float32 models, tests/test_fused_parity.py's matched
    configuration, video and proposals (frames in memory), ``run_video``
    against the fused pipeline; the options as named (``trk_kw``: other
    ``TrackerConfig`` fields). Returns (worst score, worst box) error."""
    import tempfile

    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video, vid_proto_in_memory
    from vdetlib_tpu_torch.pipeline.fused import fused_to_protos, make_fused_pipeline
    from vdetlib_tpu_torch.pipeline.fused_runner import fused_config_from_pipeline
    from vdetlib_tpu_torch.pipeline.runner import Models, PipelineConfig, run_video
    from vdetlib_tpu_torch.protos import proto_load
    from vdetlib_tpu_torch.video.detect import DetectOptions
    from vdetlib_tpu_torch.video.link import LinkOptions
    from vdetlib_tpu_torch.video.mgp import MGPOptions
    from vdetlib_tpu_torch.video.rescore import RescoreOptions
    from vdetlib_tpu_torch.video.track import TrackOptions

    T, R_, K, hw, budget = 8, 12, 4, (96, 128), 24
    sv = make_video(SynthConfig(num_frames=T, height=hw[0], width=hw[1], num_classes=K, seed=7),
                    video="vid_parity")
    rng = np.random.default_rng(7)
    rois = np.zeros((T, R_, 4), np.float32)
    for t in range(T):
        x1 = rng.uniform(0, hw[1] - 10, R_)
        y1 = rng.uniform(0, hw[0] - 10, R_)
        w = rng.uniform(8, 60, R_)
        h = rng.uniform(8, 60, R_)
        rois[t] = np.stack([x1, y1, np.minimum(x1 + w, hw[1] - 1),
                            np.minimum(y1 + h, hw[0] - 1)], axis=1)
    det, trk, trk_cfg = tiny_models(dev, **(trk_kw or {}))
    st, window, bg = (0.26, 2, 0.7) if varying_layout else (0.005, 1, 1.0)
    cfg = PipelineConfig(
        detect=DetectOptions(batch_size=4, max_rois=R_, image_hw=hw, score_thresh=st),
        mgp=MGPOptions(window=window, score_decay=0.9, nms_thresh=0.3, max_boxes=budget,
                       num_classes=K, flow_preset=flow_preset),
        track=TrackOptions(max_tracks=6, anchors_per_round=3, anchor_thresh=0.3,
                           conf_thresh=0.5, cover_thresh=0.5, batch_size=4, image_hw=hw,
                           frame_stride=1, snap_weight=snap_weight),
        tracker_cfg=trk_cfg,
        rescore=RescoreOptions(match_thresh=0.5, top_ratio=0.5, boost="max", bg_decay=bg,
                               max_boxes=budget, num_classes=K, max_tracks=6,
                               tubelet_boxes=tubelet_boxes),
        link=LinkOptions(link_thresh=0.5, suppress_thresh=0.3, max_paths=8, rescore="avg",
                         max_boxes=budget, num_classes=K, min_score=0.0, backend="device"),
    )
    vid = vid_proto_in_memory(sv)
    with tempfile.TemporaryDirectory() as tmp:
        paths = run_video(tmp, vid, staged_box_proto(rois, sv), Models(det, trk), cfg,
                          frames=sv.frames, device=dev)
        staged, tubes, track, det_proto = (proto_load(paths[k]) for k in
                                           ("final", "tubelets", "track", "detect"))
    if varying_layout:  # the fixture's precondition
        layouts = {}
        for d in det_proto["detections"]:
            layouts[d["frame"]] = layouts.get(d["frame"], ()) + (d["scores"][0]["class_index"],)
        assert len(set(layouts.values())) > 1, "the slot layout does not vary"
    pipe = make_fused_pipeline(det, trk, trk_cfg, fused_config_from_pipeline(cfg))
    with torch.no_grad():
        out = pipe(torch.from_numpy(sv.frames).to(dev), torch.from_numpy(rois).to(dev))
    fused, ftubes = fused_to_protos(out, sv.frame_ids, vid["video"])
    assert len(tubes["tracks"]) == len(ftubes["tracks"])
    if not varying_layout:
        assert int(out.n_tracks) == len(track["tracks"]) > 0, "track counts differ"

    def index(proto):
        idx = {}
        for d in proto["detections"]:
            for e in d["scores"]:
                idx.setdefault((d["frame"], e["class_index"]), []).append(
                    (e["score"], tuple(d["bbox"])))
        return {k: sorted(v) for k, v in idx.items()}

    a, b = index(staged), index(fused)
    assert set(a) == set(b) and len(a) > 0, "staged and fused (frame, class) keys differ"
    ws = wb = 0.0
    for key in a:
        assert len(a[key]) == len(b[key]), f"{key}: {len(a[key])} staged vs {len(b[key])} fused"
        for (sa, ba), (sb, bb) in zip(a[key], b[key]):
            np.testing.assert_allclose(sb, sa, rtol=1e-4, atol=1e-5, err_msg=str(key))
            np.testing.assert_allclose(bb, ba, rtol=1e-4, atol=1e-3, err_msg=str(key))
            ws = max(ws, abs(sa - sb))
            wb = max(wb, float(np.abs(np.subtract(ba, bb)).max()))
    return ws, wb


def phase_staged_sweep(dev, kernels, ctx, card):
    """Phase 12: ``run_videos`` over phase 10's videos with its loaded models
    at the ``pipeline`` tool's stage defaults; returns the launches of its
    first run."""
    import os
    import tempfile

    from vdetlib_tpu_torch.pipeline.runner import run_videos
    from vdetlib_tpu_torch.protos import proto_load

    models, entries = ctx["models"], ctx["entries"]
    cfg = staged_sweep_config(ctx["anchor_thresh"])
    names = [e[0]["video"] for e in entries]
    n_frames = sum(len(e[0]["frames"]) for e in entries)
    with tempfile.TemporaryDirectory() as tmp:
        w1, direct, w2 = (os.path.join(tmp, d) for d in ("w1", "direct", "w2"))
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        os.environ["VDETLIB_TPU_METRICS"] = metrics_path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        res = run_videos(w1, entries, models, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kernels, "staged sweep (phase 12)", ("flow_level", "track_scan"))
        peak = torch.cuda.max_memory_allocated()
        del os.environ["VDETLIB_TPU_METRICS"]
        with open(metrics_path) as f:
            records = [json.loads(line) for line in f]
        assert records[-1]["stage"] == "pipeline" and records[-1]["frames"] == n_frames
        assert not any(r.get("error") for r in res)
        stage_walls = {}
        for r in records[:-1]:
            stage_walls[r["stage"]] = stage_walls.get(r["stage"], 0.0) + r["wall_s"]
        n_tracks = [len(proto_load(r["track"])["tracks"]) for r in res]
        assert launches["flow_level"] == 2 * len(entries), \
            f"kernel A launched {launches['flow_level']} times, not twice a video"
        assert launches["track_scan"] >= sum(n > 0 for n in n_tracks), \
            "kernel F did not launch for every video that seeds a track"
        for name in ("nms_grouped", "nms_batched", "nms_sorted", "resize_normalize"):
            assert launches[name] == 0, f"kernel {name} launched in the staged sweep"
        got = stage_bytes(w1, names)
        assert all(len(got[n]) == len(STAGE_FILES) for n in names)

        # 1. the direct chain, byte for byte
        secs = direct_staged_chain(models, cfg, entries, dev, direct)
        want = stage_bytes(direct, names)
        for n in names:
            for k in STAGE_FILES:
                assert got[n][k] == want[n][k], f"staged sweep {n}/{k}.json differs from the chain's"
        n_dets = [len(json.loads(got[n]["final"])["detections"]) for n in names]
        n_tubes = [len(json.loads(got[n]["tubelets"])["tracks"]) for n in names]
        assert min(n_dets) > 0 and min(n_tubes) > 0 and min(n_tracks) > 0
        log(f"staged sweep == det_vid → mgp → track_from_det → tubelet_rescore → seq_nms_video "
            f"called directly, byte for byte, {len(names)} videos x {len(STAGE_FILES)} files "
            f"(tracks {n_tracks}, final dets {n_dets}, tubelets {n_tubes})")

        # 2. resume: nothing written; then only seq-NMS's two files
        stamps = {(n, k): os.stat(os.path.join(w1, n, f"{k}.json")).st_mtime_ns
                  for n in names for k in STAGE_FILES}
        t1 = time.perf_counter()
        run_videos(w1, entries, models, cfg, device=dev)
        resume_s = time.perf_counter() - t1
        assert {key: os.stat(os.path.join(w1, *key) + ".json").st_mtime_ns
                for key in stamps} == stamps, "a resumed sweep rewrote a stage file"
        redo = names[1]
        for k in ("final", "tubelets"):
            os.remove(os.path.join(w1, redo, f"{k}.json"))
        zero_counts(kernels)
        run_videos(w1, entries, models, cfg, device=dev)
        assert kernels["flow_level"].launches == 0 and kernels["track_scan"].launches == 0, \
            "rerunning seq-NMS launched kernel A or F"
        changed = {key for key in stamps
                   if os.stat(os.path.join(w1, *key) + ".json").st_mtime_ns != stamps[key]}
        assert changed == {(redo, "final"), (redo, "tubelets")}, changed
        assert stage_bytes(w1, names) == got, "seq-NMS rerun wrote other bytes"

        # 3. two videos' chains at once on the card
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res2 = run_videos(w2, entries[:2], models, cfg, workers=2, device=dev)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t2
        assert not any(r.get("error") for r in res2)
        assert stage_bytes(w2, names[:2]) == {n: got[n] for n in names[:2]}, \
            "workers 2 wrote other bytes than workers 1"

        # 4. keep_going over an entry one frame short (the others resume)
        vid, box, frames = entries[0]
        bad = (dict(vid, video="synth_short"), box, frames[:-1])
        kg = run_videos(w1, entries + [bad], models, cfg, keep_going=True, device=dev)
        assert "ValueError" in kg[3].get("error", "") and not os.path.exists(kg[3]["result"])
        assert not any(r.get("error") for r in kg[:3])
        assert stage_bytes(w1, names) == got, "keep_going changed the other videos"
        try:
            run_videos(w1, entries + [bad], models, cfg, device=dev)
        except ValueError as e:
            assert "in-memory frames" in str(e)
        else:
            raise AssertionError("an entry one frame short did not stop the sweep")
        log("staged sweep: the resumed sweep wrote nothing; with seq-NMS's files deleted only "
            "they were written again (same bytes, no A or F launch); workers 2 == 1 byte for "
            "byte; keep_going marked the entry one frame short failed and completed the other "
            "three; without keep_going it raised")

    # 5. staged vs fused, tiny float32 models on the card
    errs = {label: matched_staged_vs_fused(dev, vary)
            for label, vary in (("default", False), ("varying slot layout", True))}
    log("staged vs fused (tiny f32 models, tests/test_fused_parity.py's matched configuration) "
        "on the card: the same (frame, class) keys and counts, worst (score, box) "
        + ", ".join(f"{k} ({v[0]:.2e}, {v[1]:.2e} px)" for k, v in errs.items())
        + " within rtol 1e-4 and atol 1e-5 / 1e-3")

    fps = n_frames / wall
    direct_two = sum(secs[:2])
    log(f"staged sweep on {card}: {n_frames} frames in {wall:.3f} s = {fps:.2f} frames/s "
        f"(run_videos, workers 1), against phase 10's fused sweep {ctx['fps']:.2f} frames/s "
        f"on the same videos; stage walls summed over {len(names)} videos: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stage_walls.items())
        + f" (the rest, {wall - sum(stage_walls.values()):.3f} s, is the runner's proto "
        f"writes and reads); the direct chain {sum(secs):.3f} s; workers 2 over the "
        f"{names[0]} and {names[1]} videos {wall2:.3f} s against their direct chain "
        f"{direct_two:.3f} s ({direct_two / wall2:.2f}x); resume {resume_s:.3f} s; peak device "
        f"memory {peak / 2**20:.1f} MiB")
    ctx["staged_fps"] = fps  # phase 15's reference rate
    return launches


# ---------------------------------------------------------------- phase 13


OPTION_LENGTHS = VIDEO_LENGTHS[:2]  # phase 5's 64- and 50-frame videos (one bucket)
# the options of every run of phase 13 (both engines): detection snapping,
# tubelet boxes and the "accurate" flow pyramid; with EMA templates, then
# with three scales in their place
OPTIONS = dict(snap_weight=0.5, tubelet_boxes=True, flow_preset="accurate")
EMA = dict(template_eta=0.1)
SCALES = dict(num_scales=3)
STREAM_OPTION_T = 64  # two full stream chunks


def fused_option_run(dev, kernels, det, trk, trk_cfg, fcfg, videos, label, need_f):
    """Phase 5's pipeline with ``fcfg`` and ``trk_cfg`` over ``videos``:
    every output finite, tracks and paths found; kernel A 6 times a video
    (3 pyramid levels, 2 flow directions), F at least once a video where
    ``need_f``, else never. Returns (frames/s, launches)."""
    from vdetlib_tpu_torch.pipeline.fused import fused_to_protos, make_fused_pipeline

    pipe = make_fused_pipeline(det, trk, trk_cfg, fcfg)
    zero_counts(kernels)
    wall, n_frames = 0.0, 0
    for i, (frames, rois, t_valid, roi_mask, fids) in enumerate(videos):
        args = [torch.from_numpy(a).to(dev) for a in (frames, rois, roi_mask)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipe(args[0], args[1], t_valid, args[2])
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        n_frames += t_valid
        floats = [out.det_boxes, out.det_scores, out.final_scores, out.track_boxes,
                  out.track_conf, out.tubelet_stats]
        assert all(bool(torch.isfinite(x).all()) for x in floats), f"{label}: non-finite output"
        assert int(out.n_tracks) >= 1 and bool((out.path_ids >= 0).any()), f"{label}: no tracks"
        det_proto, tubes = fused_to_protos(out, fids, f"opt{i}")
        assert len(det_proto["detections"]) > 0 and len(tubes["tracks"]) > 0
    launches = read_counts(kernels, f"fused slice, {label} (phase 13)", ("flow_level",))
    n = len(videos)
    assert launches["flow_level"] == 6 * n, \
        f"{label}: kernel A launched {launches['flow_level']} times, not 6 a video"
    if need_f:
        assert launches["track_scan"] >= n, f"{label}: kernel F did not launch every video"
    else:
        assert launches["track_scan"] == 0, f"{label}: kernel F launched outside its contract"
    return n_frames / wall, launches


def torch_scan_rounds(dev, records):
    """The folded scan's plain version (the scan of every option run) on
    phase 3's 48-step round (the staged tracker's features, 8 anchors):
    ms a round frozen (phase 3), with snapping and EMA templates, and with
    three scales, beside kernel F's."""
    from vdetlib_tpu_torch.kernels import track_scan as kf
    from vdetlib_tpu_torch.nn.tracker_net import extract_template

    _, trk, cfg = base_models(dev)
    sv = staged_video(NATIVE_HW)
    with torch.no_grad():
        feats = staged_features(trk, sv.frames, dev)
    Ts = feats.shape[0]
    rng = np.random.default_rng(7)
    ats = torch.from_numpy(rng.integers(0, Ts, A)).to(dev)
    k = np.arange(A) % sv.gt_boxes.shape[0]
    boxes = torch.from_numpy(sv.gt_boxes[k, 2 * ats.cpu().numpy()].astype(np.float32)).to(dev)
    tpl = extract_template(feats[ats], boxes, cfg)
    n = 16  # candidate dets a frame, jittered ground truth
    db = sv.gt_boxes[np.arange(n) % sv.gt_boxes.shape[0]][:, ::2].transpose(1, 0, 2)
    db = db + rng.normal(0, 3, db.shape)
    snap = (torch.from_numpy(db.astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0.3, 1, (Ts, n)).astype(np.float32)).to(dev),
            torch.ones((Ts, n), dtype=torch.bool, device=dev))
    ema = dataclasses.replace(cfg, **EMA)
    with torch.no_grad():
        snap_ema = cuda_ms(lambda: kf.track_scan_plain(feats, ats, boxes, tpl, ema, 0.5,
                                                       snap=snap), iters=2, warmup=1)
        scales = cuda_ms(lambda: kf.track_scan_plain(feats, ats, boxes, tpl,
                                                     dataclasses.replace(cfg, **SCALES), 0.5),
                         iters=2, warmup=1)
    f = records["track_scan"]
    log(f"torch scan, one {Ts}-step round of {2 * A} lanes over {tuple(feats.shape)}: frozen "
        f"{f['plain_ms']:.2f} ms (phase 3), snapping + EMA templates {snap_ema:.2f} ms, three "
        f"scales {scales:.2f} ms; kernel F {f['ms']:.4f} ms wall, {f['device_ms']:.5f} ms "
        f"device (phase 3)")
    return {"snap_ema_ms": snap_ema, "scales3_ms": scales}


def option_sweep_config(anchor_thresh):
    """Phase 12's staged sweep config (the pipeline tool's stage defaults)
    with every option: snapping, EMA templates, tubelet boxes, the pyramid."""
    cfg = staged_sweep_config(anchor_thresh)
    return dataclasses.replace(
        cfg, mgp=dataclasses.replace(cfg.mgp, flow_preset=OPTIONS["flow_preset"]),
        track=dataclasses.replace(cfg.track, snap_weight=OPTIONS["snap_weight"]),
        tracker_cfg=dataclasses.replace(cfg.tracker_cfg, **EMA),
        rescore=dataclasses.replace(cfg.rescore, tubelet_boxes=OPTIONS["tubelet_boxes"]))


def option_sweeps(dev, kernels, ctx):
    """Phase 10's loaded models through ``run_videos`` and
    ``run_videos_fused`` with every option over the first two videos: the
    staged files equal the stages called one by one, byte for byte; A 6
    times a video in each engine, F never. Returns (staged, fused) frames/s."""
    import os
    import tempfile

    from vdetlib_tpu_torch.pipeline.fused_runner import run_videos_fused
    from vdetlib_tpu_torch.pipeline.runner import run_videos

    models, entries = ctx["models"], ctx["entries"][:2]
    cfg = option_sweep_config(ctx["anchor_thresh"])
    names = [e[0]["video"] for e in entries]
    n_frames = sum(len(e[0]["frames"]) for e in entries)
    fps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine, run in (("staged", lambda d: run_videos(d, entries, models, cfg,
                                                                 device=dev)),
                            ("fused", lambda d: run_videos_fused(d, entries, models, cfg))):
            zero_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(os.path.join(tmp, engine))
            torch.cuda.synchronize()
            fps[engine] = n_frames / (time.perf_counter() - t0)
            assert not any(r.get("error") for r in res)
            launches = read_counts(kernels, f"{engine} sweep with every option (phase 13)",
                                   ("flow_level",))
            assert launches["flow_level"] == 6 * len(entries), \
                f"{engine} sweep: kernel A launched {launches['flow_level']} times"
            assert launches["track_scan"] == 0, f"{engine} sweep: kernel F launched"
            for r in res:
                assert len(json.loads(open(r["final"]).read())["detections"]) > 0
        got = stage_bytes(os.path.join(tmp, "staged"), names)
        direct_staged_chain(models, cfg, entries, dev, os.path.join(tmp, "direct"))
        want = stage_bytes(os.path.join(tmp, "direct"), names)
        for n in names:
            assert len(got[n]) == len(STAGE_FILES)
            for k in STAGE_FILES:
                assert got[n][k] == want[n][k], \
                    f"option sweep {n}/{k}.json differs from the chain's"
    log("staged sweep with every option == the stages called one by one, byte for byte, "
        f"{len(names)} videos x {len(STAGE_FILES)} files")
    return fps["staged"], fps["fused"]


def phase_options(dev, kernels, card, slice_cfg, slice_fps, sweep_ctx, stream_opts, records):
    """Phase 13: detection snapping, EMA templates, three scales, tubelet
    boxes and the "accurate" flow pyramid at the base model's full width,
    through the fused pipeline, both sweeps and the stream; the tiny float32
    pipeline and stream with them, card against CPU."""
    from vdetlib_tpu_torch.video.stream import stream_video

    det, trk, trk_cfg = base_models(dev)
    videos = [slice_inputs(T, seed) for seed, T in enumerate(OPTION_LENGTHS)]
    fcfg = dataclasses.replace(slice_cfg, **OPTIONS)
    rates, launches = {}, {}
    for label, tc, need_f, cfg in (
            ("snapping + EMA + tubelet boxes + accurate", dataclasses.replace(trk_cfg, **EMA),
             False, fcfg),
            ("snapping + 3 scales + tubelet boxes + accurate",
             dataclasses.replace(trk_cfg, **SCALES), False, fcfg),
            ("control: tubelet boxes + accurate, no snapping, eta 0", trk_cfg, True,
             dataclasses.replace(fcfg, snap_weight=0.0))):
        rates[label], launches[label] = fused_option_run(dev, kernels, det, trk, tc, cfg,
                                                         videos, label, need_f)
    n_frames = sum(OPTION_LENGTHS)
    log(f"options on {card}: fused slice over {n_frames} frames, "
        + ", ".join(f"{k} {v:.2f} frames/s" for k, v in rates.items())
        + f"; phase 5's pipeline-only {slice_fps:.2f} frames/s (default options)")
    scan = torch_scan_rounds(dev, records)
    staged_fps, fused_fps = option_sweeps(dev, kernels, sweep_ctx)
    n_sweep = sum(len(e[0]["frames"]) for e in sweep_ctx["entries"][:2])
    log(f"options on {card}: staged sweep {staged_fps:.2f} frames/s, fused sweep "
        f"{fused_fps:.2f} frames/s (every option, EMA; {n_sweep} frames); phase 10's fused "
        f"sweep {sweep_ctx['fps']:.2f} frames/s (default options)")

    # the tiny float32 pipeline with every option: card == CPU; staged == fused
    frames, rois, roi_mask = tiny_inputs()
    kw = dict(OPTIONS, snap_iou=0.4)
    with torch.no_grad():
        want = tiny_pipeline("cpu", trk_kw=EMA, **kw)(
            *(torch.from_numpy(a) for a in (frames, rois)), None, torch.from_numpy(roi_mask))
        got = tiny_pipeline(dev, trk_kw=EMA, **kw)(
            *(torch.from_numpy(a).to(dev) for a in (frames, rois)), None,
            torch.from_numpy(roi_mask).to(dev))
    torch.cuda.synchronize()
    worst = compare_outputs(got, want)
    assert int(want.n_tracks) >= 1 and bool(want.det_mask.any())
    errs = {label: matched_staged_vs_fused(dev, vary, snap_weight=0.5, tubelet_boxes=True,
                                           flow_preset="accurate", trk_kw=EMA)
            for label, vary in (("default", False), ("varying slot layout", True))}
    log(f"tiny f32 pipeline with every option (EMA) on {dev} == CPU within phase 4's bounds "
        f"(worst float diff {worst:.6f}); staged == fused: "
        + ", ".join(f"{k} (score {v[0]:.2e}, box {v[1]:.2e} px)" for k, v in errs.items()))

    # the stream at the tool's defaults with EMA templates: both engines,
    # bit for bit, at strides 1 and 2; the tiny stream against the CPU
    sv = synth(STREAM_OPTION_T, seed=10)
    rois = make_rois(STREAM_OPTION_T, seed=10, r=stream_opts.max_rois)
    ema_cfg = dataclasses.replace(trk_cfg, **EMA)
    chunk_ms = {}
    for stride in (1, 2):
        res = {}
        for engine in ("fused", "host"):
            opts = dataclasses.replace(stream_opts, engine=engine, track_stride=stride)
            zero_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[engine] = stream_video(det, trk, ema_cfg, (sv.frames[s:s + opts.chunk] for s in
                                                           range(0, STREAM_OPTION_T, opts.chunk)),
                                       rois, opts)
            torch.cuda.synchronize()
            chunk_ms[(engine, stride)] = (time.perf_counter() - t0) * 1e3 * opts.chunk \
                / STREAM_OPTION_T
            read_counts(kernels, f"stream, EMA, {engine} engine, stride {stride} (phase 13)",
                        ("flow_level", "nms_grouped", "nms_batched"))
        diff = stream_difference(res["fused"], res["host"])
        assert diff is None, f"stream with EMA, stride {stride}: the engines differ in {diff}"
        assert len(res["host"]["tracks"]) >= 1, "the stream with EMA seeded no track"
    frames12, rois12, _ = tiny_inputs(seed=8, T=12)
    for stride in (1, 2):
        for engine in ("fused", "host"):
            kw = dict(engine=engine, track_stride=stride)
            w = compare_streams(tiny_stream(dev, frames12, rois12, trk_kw=EMA, **kw),
                                tiny_stream("cpu", frames12, rois12, trk_kw=EMA, **kw))
            log(f"tiny f32 stream with EMA, {engine} engine, stride {stride}, on {dev} == CPU "
                f"(worst float diff {w:.6f})")
    log(f"stream with EMA templates on {card} (the tool's defaults, {STREAM_OPTION_T} frames): "
        f"fused == host bit for bit at strides 1 and 2; wall per {stream_opts.chunk}-frame "
        f"chunk (seq-NMS included): " + ", ".join(f"{e} stride {s} {v:.1f} ms"
                                                  for (e, s), v in chunk_ms.items()))
    return dict(rates=rates, scan=scan, staged_fps=staged_fps, fused_fps=fused_fps,
                launches=next(iter(launches.values())))


# ---------------------------------------------------------------- phase 14

TRAIN_STEPS = 30  # full-width steps of each trainer
TRAIN_B, TRAIN_R = 8, 64  # the train_detector tool's batch and ROIs
TRAIN_LR = 1e-3


def detector_step_ops(det, hw, batch, rois):
    """(bf16 operations, float32 operations) of one training step: the
    forward's convolutions (bf16) and its ROI align and head (float32
    matmuls), counted from the model's shapes, times 3 (the backward
    computes a gradient for the input and one for the weights)."""
    bb = det.backbone
    h, w = -(-hw[0] // 2), -(-hw[1] // 2)
    conv = 2 * 49 * 3 * bb.config.stem_features * h * w
    h, w = -(-h // 2), -(-w // 2)  # the max-pool
    for blk in bb.blocks:
        s = blk.conv0.stride[0]
        h, w = -(-h // s), -(-w // s)
        cin, cout = blk.conv0.in_channels, blk.conv0.out_channels
        conv += 2 * 9 * (cin + cout) * cout * h * w
        if blk.has_proj:
            conv += 2 * cin * cout * h * w
    head = det.head
    P = det.config.roi_pool
    C_out = bb.out_features
    pool = 2 * P * h * w * C_out + 2 * P * P * w * C_out
    mlp = 2 * (head.fc0.in_features * head.fc0.out_features
               + head.fc1.in_features * head.fc1.out_features
               + head.cls.in_features * (head.cls.out_features + head.bbox.out_features))
    return 3 * batch * conv, 3 * batch * rois * (pool + mlp)


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}


def compare_grads(label, got, want, rel):
    """Every gradient within ``rel`` of its CPU tensor's largest magnitude;
    returns the worst ratio."""
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-12)
        assert err <= rel, f"{label}: the gradient of {k} differs by {err:.2e} of its largest"
        worst = max(worst, err)
    return worst


def train_step_card_vs_cpu(label, model_cpu, loss_fn, batch, dev, grad_rel, max_norm):
    """One step's loss and gradients on the card against the CPU (the same
    weights and batch), then the optimizer on the card given the CPU's
    gradients against the CPU's: returns (loss diff, worst grad ratio,
    worst parameter diff)."""
    import copy

    from vdetlib_tpu_torch.nn.train import make_optimizer

    model_dev = copy.deepcopy(model_cpu).to(dev)
    losses, grads = {}, {}
    for m, d in ((model_cpu, "cpu"), (model_dev, dev)):
        m.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m, {k: v.to(d) for k, v in batch.items()})
        loss.backward()
        losses[str(d)], grads[str(d)] = float(loss.detach()), grads_of(m)
    want = losses["cpu"]
    got = losses[str(dev)]
    assert math.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), \
        f"{label}: loss {got} on the card, {want} on the CPU"
    worst = compare_grads(label, grads[str(dev)], grads["cpu"], grad_rel)
    opts = [make_optimizer(m.parameters(), TRAIN_LR, max_norm=max_norm)
            for m in (model_cpu, model_dev)]
    for p_dev, p_cpu in zip(model_dev.parameters(), model_cpu.parameters()):
        p_dev.grad.copy_(p_cpu.grad)
    for o in opts:
        o.step()
    p_err = 0.0
    for (n, a), b in zip(model_cpu.named_parameters(), model_dev.parameters()):
        a, b = a.detach(), b.detach().cpu()
        err = float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
        assert err <= 1e-6, f"{label}: the update of {n} differs by {err:.2e} on the card"
        p_err = max(p_err, err)
    return abs(got - want) / abs(want), worst, p_err


def tiny_train_cases(dev):
    """The card-vs-CPU step of the tiny float32 detector and of the float32
    tracker's two recipes at 96×128 (tests/test_torch_train*.py's sizes)."""
    from vdetlib_tpu_torch.cli.train_detector import BatchOptions
    from vdetlib_tpu_torch.data.synth import SynthConfig, hard_config, make_video
    from vdetlib_tpu_torch.nn import tracker_train as ttt
    from vdetlib_tpu_torch.nn import train as ttrain

    det, trk, trk_cfg = tiny_models("cpu")
    sv = make_video(SynthConfig(num_frames=8, height=96, width=128, num_classes=4, seed=1))
    batch = ttrain.make_training_batch(sv, np.random.default_rng(3), BatchOptions(2, 16, True), 4)
    out = {"detector": train_step_card_vs_cpu("tiny detector step", det, ttrain.loss_and_terms,
                                              batch, dev, 1e-4, 10.0)}
    hard = [make_video(hard_config(num_frames=24, height=96, width=128, seed=200 + i))
            for i in range(2)]
    for recipe in ("pair", "aware"):
        rng = np.random.default_rng(3)
        b = (ttt.make_tracker_batch_aware(hard, rng, 8, trk_cfg) if recipe == "aware"
             else ttt.make_tracker_batch(hard, rng, 8))
        fn = ttt.tracker_loss_for(recipe)
        out[f"tracker {recipe}"] = train_step_card_vs_cpu(
            f"tiny tracker step ({recipe})", trk, lambda m, bb, fn=fn: fn(m, trk_cfg, bb), b, dev,
            1e-3, 5.0)
    return out


def timed_steps(step_fn, batches):
    """Runs ``step_fn`` on each batch; returns (losses, ms a step by CUDA events)."""
    losses, ms = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        aux = step_fn(b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(aux["loss"]))
    return losses, ms


def device_breakdown(label, fn, wall_ms, iters=3):
    """Device time of ``iters`` calls of ``fn`` (one training step each) by
    kind of kernel, from torch.profiler's CUPTI records, and the device's
    idle share of ``wall_ms`` a step."""
    kinds = {"convolution": ("conv", "cudnn", "fprop", "dgrad", "wgrad"),
             "matmul": ("gemm", "xmma", "cutlass"),
             "optimizer": ("multi_tensor", "foreach"), "copy or fill": ("memcpy", "memset")}
    by_kind = {}
    for name, us in device_records(fn, iters):
        low = name.lower()
        kind = next((k for k, keys in kinds.items() if any(x in low for x in keys)),
                    "elementwise and reductions")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / iters / 1e3
    busy = sum(by_kind.values())
    log(f"{label}: device {busy:.2f} ms a step of {wall_ms:.2f} ms wall (idle "
        f"{max(0.0, 1 - busy / wall_ms):.0%}): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    return dict(device_ms=busy, by_kind=by_kind)


def check_falls(label, losses):
    assert all(math.isfinite(x) for x in losses), f"{label}: a loss is not finite: {losses}"
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert last < first, f"{label}: the loss did not fall ({first:.4f} -> {last:.4f})"
    return first, last


def full_width_detector(dev, card):
    """TRAIN_STEPS steps of the base detector at the train_detector tool's
    recipe (augmentation, cosine schedule) at full width."""
    from vdetlib_tpu_torch.cli.train_detector import BatchOptions
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.nn import train as ttrain
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.weights import init_detector

    videos = [make_video(SynthConfig(num_frames=16, height=H, width=W, num_classes=C,
                                     seed=300 + i)) for i in range(4)]
    rng = np.random.default_rng(0)
    opts = BatchOptions(TRAIN_B, TRAIN_R, True)
    batches = [ttrain.make_training_batch(videos[int(rng.integers(0, len(videos)))], rng, opts, C)
               for _ in range(TRAIN_STEPS)]
    det = init_detector(detector_preset("base", num_classes=C), torch.Generator().manual_seed(0),
                        device=dev)
    opt = ttrain.make_optimizer(det.parameters(), TRAIN_LR, schedule="cosine",
                                total_steps=TRAIN_STEPS)
    det.train()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(lambda b: ttrain.train_step(det, opt, b), batches)
    peak = torch.cuda.max_memory_allocated()
    first, last = check_falls("base detector", losses)
    step_ms = float(np.median(ms[3:]))
    bf16_ops, f32_ops = detector_step_ops(det, (H, W), TRAIN_B, TRAIN_R)
    bound_ms = (bf16_ops / BF16_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    log(f"base detector training on {card}: {TRAIN_STEPS} steps (C={C}, {H}x{W}, batch "
        f"{TRAIN_B}, {TRAIN_R} ROIs, cosine), loss {first:.4f} -> {last:.4f} (means of the "
        f"first and last 5); {step_ms:.2f} ms a step (median of steps 3-{TRAIN_STEPS - 1}, CUDA "
        f"events; first {ms[0]:.1f} ms), {1e3 / step_ms:.2f} steps/s; peak memory "
        f"{peak / 2**20:.1f} MiB; operations bound {bound_ms:.3f} ms ({bf16_ops / 1e9:.1f} G "
        f"bf16 convolution + {f32_ops / 1e9:.1f} G float32 head operations)")
    dev_rec = device_breakdown("base detector step", lambda: ttrain.train_step(
        det, opt, batches[-1]), step_ms)
    return det, dict(step_ms=step_ms, first_ms=ms[0], peak_mib=peak / 2**20, bound_ms=bound_ms,
                     loss_first=first, loss_last=last, **dev_rec)


def full_width_tracker(dev, card, recipe):
    """TRAIN_STEPS steps of the default TrackerConfig at 240×320, batch 8
    ("aware": the hard tier's videos and sampler)."""
    from vdetlib_tpu_torch.data.synth import SynthConfig, hard_config, make_video
    from vdetlib_tpu_torch.nn import tracker_train as ttt
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.weights import init_tracker

    cfg = TrackerConfig()
    mk = hard_config if recipe == "aware" else SynthConfig
    videos = [make_video(mk(num_frames=24, height=H, width=W, seed=400 + i)) for i in range(3)]
    rng = np.random.default_rng(0)
    batches = [ttt.make_tracker_batch_aware(videos, rng, TRAIN_B, cfg) if recipe == "aware"
               else ttt.make_tracker_batch(videos, rng, TRAIN_B) for _ in range(TRAIN_STEPS)]
    trk = init_tracker(cfg, torch.Generator().manual_seed(1), device=dev).train()
    opt = ttt.make_tracker_optimizer(trk, TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(lambda b: ttt.tracker_train_step(trk, cfg, opt, b, recipe), batches)
    peak = torch.cuda.max_memory_allocated()
    first, last = check_falls(f"tracker ({recipe})", losses)
    step_ms = float(np.median(ms[3:]))
    log(f"tracker training ({recipe}) on {card}: {TRAIN_STEPS} steps (default TrackerConfig, "
        f"{H}x{W}, batch {TRAIN_B}), loss {first:.4f} -> {last:.4f}; {step_ms:.2f} ms a step "
        f"(first {ms[0]:.1f} ms), {1e3 / step_ms:.2f} steps/s; peak memory "
        f"{peak / 2**20:.1f} MiB")
    dev_rec = device_breakdown(f"tracker step ({recipe})", lambda: ttt.tracker_train_step(
        trk, cfg, opt, batches[-1], recipe), step_ms)
    return dict(step_ms=step_ms, peak_mib=peak / 2**20, loss_first=first, loss_last=last,
                **dev_rec)


def heldout_eval_case(dev, kernels, det):
    """The trainer's held-out eval with ``det``: kernel C must launch (the
    count is returned), and C equals its plain version on the eval's own
    per-class NMS problems."""
    from vdetlib_tpu_torch.cli.train_detector import evaluate_heldout_map, heldout_problems
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.kernels import nms_batched as kc
    from vdetlib_tpu_torch.kernels import nms_grouped as kb

    heldout = [make_video(SynthConfig(num_frames=16, height=H, width=W, num_classes=C,
                                      seed=10_300 + i)) for i in range(4)]
    det.eval()
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, per_class = evaluate_heldout_map(det, heldout, C, TRAIN_R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels, "trainer's held-out eval (phase 14)", ("nms_batched",))
    assert sum(launches.values()) == launches["nms_batched"], \
        "the held-out eval launched a kernel other than C"
    kept = valid = 0
    for sv in heldout:
        boxes, scores, ok = heldout_problems(det, sv, TRAIN_R)
        n = boxes.shape[-2]
        args = (boxes.reshape(-1, n, 4).contiguous(), scores.reshape(-1, n).contiguous(),
                ok.reshape(-1, n).contiguous())
        got = kc.nms_batched_kernel(*args, 0.3)
        want = kb.nms_unsorted_fixpoint(*args, 0.3)
        assert torch.equal(got, want), f"kernel C differs from its plain version on {sv.video}"
        kept += int(got.sum())
        valid += int(args[2].sum())
    log(f"trainer's held-out eval: mAP@0.5 {m:.4f} over {len(heldout)} videos of 16 frames "
        f"({len(per_class)} classes with ground truth), {wall:.2f} s; kernel C launched "
        f"{launches['nms_batched']} times, keep sets equal to the plain version on the eval's "
        f"problems ({kept} of {valid} valid kept, {TRAIN_R} slots)")
    return launches["nms_batched"], m


def resume_case(dev, tmp):
    """A train-state save after two steps, a load into a fresh state of
    another seed, and the third step in both, bit for bit (cuDNN's
    deterministic algorithms for the check: its default backward
    algorithms may sum in any order)."""
    import os

    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.nn import train as ttrain
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.pipeline.checkpoint import load_train_state, save_train_state
    from vdetlib_tpu_torch.weights import init_detector

    from vdetlib_tpu_torch.cli.train_detector import BatchOptions

    sv = make_video(SynthConfig(num_frames=8, height=96, width=128, num_classes=4, seed=2))
    rng = np.random.default_rng(9)
    batches = [ttrain.make_training_batch(sv, rng, BatchOptions(4, 32, True), 4)
               for _ in range(3)]

    def state(seed):
        m = init_detector(detector_preset("tiny", num_classes=4),
                          torch.Generator().manual_seed(seed), device=dev)
        o = ttrain.make_optimizer(m.parameters(), TRAIN_LR, schedule="cosine", total_steps=20)
        return ttrain.init_train_state(m, o)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        st = state(0)
        for b in batches[:2]:
            ttrain.train_step(st.model, st.opt, b)
            st.step += 1
        path = os.path.join(tmp, "train_state.pt")
        save_train_state(path, st)
        want = ttrain.train_step(st.model, st.opt, batches[2])
        got_state = load_train_state(path, state(5))
        assert got_state.step == 2 and got_state.opt.updates_made() == 2
        got = ttrain.train_step(got_state.model, got_state.opt, batches[2])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(got["loss"], want["loss"]), "the resumed step's loss differs"
    for (n, a), b in zip(got_state.model.state_dict().items(), st.model.state_dict().values()):
        assert torch.equal(a, b), f"the resumed step's {n} differs"
    sa, sb = got_state.opt.state_dict()["state"], st.opt.state_dict()["state"]
    for i in sb:
        for k in sb[i]:
            assert torch.equal(sa[i][k], sb[i][k]), f"the resumed optimizer's {k} of {i} differs"
    log(f"train state: saved after 2 steps ({os.path.getsize(path)} bytes), loaded into a "
        f"fresh state, the third step equal bit for bit (parameters, moments, loss)")


def tool_case(dev, kernels, tmp):
    """``train_detector`` through ``main`` on the card with ``--eval_every``;
    its checkpoint loads into the tiny fused pipeline's detector, which runs."""
    import io
    import os

    from vdetlib_tpu_torch.cli import train_detector
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.pipeline.checkpoint import load_params
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig, make_fused_pipeline
    from vdetlib_tpu_torch.weights import init_detector

    out = os.path.join(tmp, "det.pt")
    zero_counts(kernels)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_detector.main([out, "--model", "tiny", "--image_hw", "96", "128", "--steps",
                                  "8", "--eval_every", "4", "--eval_videos", "2",
                                  "--num_videos", "2", "--frames_per_video", "8",
                                  "--device", str(dev)])
    wall = time.perf_counter() - t0
    assert rc == 0 and os.path.exists(out), "train_detector wrote no checkpoint"
    launches = read_counts(kernels, "train_detector tool (phase 14)", ("nms_batched",))
    det = init_detector(detector_preset("tiny", num_classes=4), torch.Generator().manual_seed(9),
                        device=dev)
    load_params(out, det)
    _, trk, trk_cfg = tiny_models(dev)
    cfg = FusedConfig(image_hw=(96, 128), detect_batch=8, feat_batch=8, anchors_per_round=4,
                      max_tracks=8, max_paths=16, det_budget=24, out_budget=24,
                      score_thresh=0.2, anchor_thresh=0.26)
    frames, rois, roi_mask = tiny_inputs()
    with torch.no_grad():
        res = make_fused_pipeline(det, trk, trk_cfg, cfg)(
            *(torch.from_numpy(a).to(dev) for a in (frames, rois)), None,
            torch.from_numpy(roi_mask).to(dev))
    torch.cuda.synchronize()
    assert torch.isfinite(res.det_scores).all() and torch.isfinite(res.det_boxes).all()
    summary = [x for x in buf.getvalue().splitlines() if x.startswith("trained")]
    log(f"train_detector --device {dev} (tiny, 8 steps, eval every 4): {wall:.1f} s, "
        f"C launched {launches['nms_batched']} times by its evals; {summary[0]}; its checkpoint "
        f"({os.path.getsize(out)} bytes) loaded into the fused pipeline's detector, which ran")


def phase_training(dev, kernels, card):
    """Phase 14: the trainers on the card (see the module docstring)."""
    import tempfile

    cases = tiny_train_cases(dev)
    log("tiny float32 training steps, card == CPU: " + "; ".join(
        f"{k} loss {v[0]:.1e} relative, gradients {v[1]:.1e} of their largest, the update "
        f"given the CPU's gradients {v[2]:.1e}" for k, v in cases.items()))
    det, det_rec = full_width_detector(dev, card)
    trk_recs = {r: full_width_tracker(dev, card, r) for r in ("pair", "aware")}
    launches, m = heldout_eval_case(dev, kernels, det)
    del det
    with tempfile.TemporaryDirectory() as tmp:
        resume_case(dev, tmp)
        tool_case(dev, kernels, tmp)
    return dict(launches=launches, heldout_map=m, detector=det_rec, tracker=trk_recs)



# ---------------------------------------------------------------- phase 15

SUBMISSION_LINE = (r"^\d+ \d+ \d+\.\d{6} -?\d+\.\d{2} -?\d+\.\d{2} -?\d+\.\d{2} "
                   r"-?\d+\.\d{2}$")  # tests/test_vid_rehearsal.py's format


def serve_queue(entries, data_dir, with_box=True):
    """Phase 10's entries as a serving queue: ``NAME.vid.json`` (placeholder
    paths) and ``NAME.box.json`` under ``data_dir``; returns the frames by name."""
    import os

    from vdetlib_tpu_torch.protos import proto_dump

    os.makedirs(data_dir, exist_ok=True)
    for vid, box, _ in entries:
        proto_dump(vid, os.path.join(data_dir, f"{vid['video']}.vid.json"))
        if with_box:
            proto_dump(box, os.path.join(data_dir, f"{vid['video']}.box.json"))
    return {vid["video"]: frames for vid, _, frames in entries}


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    import pathlib

    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def tree_stamps(root):
    import pathlib

    return {str(p): p.stat().st_mtime_ns for p in pathlib.Path(root).rglob("*")}


def serve_engine(dev, kernels, label, data, work, models, cfg, frames, need):
    """One ``serve_loop`` pass over the queue: its records, launches and peak
    memory."""
    from vdetlib_tpu_torch.cli.serve import serve_loop

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    recs = serve_loop(data, work, models, cfg, engine=label, once=True, device=dev,
                      frames=frames)
    torch.cuda.synchronize()
    launches = read_counts(kernels, f"serve --engine {label} (phase 15)", need)
    return recs, launches, torch.cuda.max_memory_allocated()


def run_tool(tool, argv):
    """A tool of the port through its dispatcher; (return code, its stdout)."""
    import io

    from vdetlib_tpu_torch.__main__ import dispatch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dispatch(tool, argv)
    return rc, out.getvalue()


def host_tools(tmp, work, entries):
    """Phase 15 (b): ``calibrate`` (rank; platt fit on the three (det, annot)
    pairs with ``--save_model``), ``write_submission --calibration`` and
    ``eval_vid --json_out`` over the fused engine's outputs; returns the mAP."""
    import os
    import re
    import shutil

    from vdetlib_tpu_torch.data.synth import annot_proto
    from vdetlib_tpu_torch.evaluation.vid_map import vid_map
    from vdetlib_tpu_torch.protos import proto_dump, proto_load

    tools = os.path.join(tmp, "tools")
    os.makedirs(tools)
    vids, dets, annots = [], [], []
    for i, (vid, _, _) in enumerate(entries):
        name = vid["video"]
        sv = dataclasses.replace(synth(len(vid["frames"]), i), video=name)
        paths = {k: os.path.join(tools, f"{name}.{k}.json") for k in ("vid", "final", "annot")}
        proto_dump(vid, paths["vid"])
        proto_dump(annot_proto(sv), paths["annot"])
        shutil.copyfile(os.path.join(work, name, "final.json"), paths["final"])
        vids.append(paths["vid"])
        dets.append(paths["final"])
        annots.append(paths["annot"])
    rc, _ = run_tool("calibrate", dets)
    assert rc == 0 and all(os.path.exists(d[:-5] + ".cal.json") for d in dets)
    model = os.path.join(tools, "platt.json")
    rc, _ = run_tool("calibrate", [*dets, "--method", "platt", "--suffix", ".platt.json",
                                   "--val_dets", *dets, "--val_annots", *annots,
                                   "--save_model", model])
    assert rc == 0 and os.path.exists(model)
    with open(model) as f:
        fit = json.load(f)
    sub = os.path.join(tools, "submission.txt")
    rc, printed = run_tool("write_submission", [sub, "--pairs",
                                                *[p for vd in zip(vids, dets) for p in vd],
                                                "--calibration", model])
    assert rc == 0
    with open(sub) as f:
        lines = f.read().splitlines()
    n_scores = sum(len(d["scores"]) for p in dets for d in proto_load(p)["detections"])
    assert len(lines) == n_scores > 0, (len(lines), n_scores)
    pat = re.compile(SUBMISSION_LINE)
    assert all(pat.match(line) for line in lines), "a submission line is malformed"
    # frames numbered globally: video i's lines lie after the frames of videos < i
    lengths = [len(e[0]["frames"]) for e in entries]
    offsets = np.cumsum([0] + lengths)
    frames = [int(line.split()[0]) for line in lines]
    assert min(frames) >= 1 and max(frames) <= offsets[-1]
    assert sorted({int(np.searchsorted(offsets, f, side="left")) - 1 for f in frames}) == \
        list(range(len(entries))), "the submission does not cover every video"
    ev = os.path.join(tools, "eval.json")
    rc, printed = run_tool("eval_vid", ["--pairs", *[p for da in zip(dets, annots) for p in da],
                                        "--json_out", ev])
    assert rc == 0
    with open(ev) as f:
        res = json.load(f)
    m, _ = vid_map([(proto_load(d), proto_load(a)) for d, a in zip(dets, annots)])
    assert res["mAP"] == m and re.search(rf"^mAP = {m:.4f}$", printed, re.M), \
        (res["mAP"], m, printed)
    log(f"host tools on the card's machine: calibrate rank wrote {len(dets)} files; calibrate "
        f"platt fit {len(fit['per_class'])} classes (global a, b = "
        f"{fit['global'][0]:.4f}, {fit['global'][1]:.4f}) and saved them; write_submission "
        f"--calibration wrote {len(lines)} lines over {len(entries)} videos in the rehearsal's "
        f"format, frames numbered 1..{max(frames)} globally; eval_vid mAP = {m:.4f} == vid_map "
        f"of the same pairs (random weights: not gated)")
    return m


def phase_serve(dev, kernels, ctx, card):
    """Phase 15: the serving daemon (``cli/serve.py``) on both engines over
    phase 10's videos, from phase 10's checkpoints, and the host tools over
    its outputs; returns the launches of A, B and F by engine."""
    import os
    import tempfile

    import vdetlib_tpu_torch.pipeline.runner as runner
    from vdetlib_tpu_torch.cli import serve
    from vdetlib_tpu_torch.kernels.build import KernelError
    from vdetlib_tpu_torch.pipeline.fused_runner import FusedEngine
    from vdetlib_tpu_torch.protos import proto_dump, proto_load

    entries = ctx["entries"]
    names = [e[0]["video"] for e in entries]
    n_frames = sum(len(e[0]["frames"]) for e in entries)
    ckpt = ctx["checkpoints"]
    args = serve.parse_args([
        "DATA", "WORK", "--model", "base", "--num_classes", str(C), "--image_hw", str(H),
        str(W), "--max_rois", str(R), "--once", "--detector_weights", ckpt["detector"],
        "--tracker_weights", ckpt["tracker"]])
    assert (args.model, args.num_classes, args.max_rois, args.device) == ("base", C, R, "cuda")
    models = serve.build_models(args, dev)
    for name, a, b in (("detector", ctx["models"].detector, models.detector),
                       ("tracker", ctx["models"].tracker, models.tracker)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa), \
            f"build_models' {name} differs from phase 10's loaded one"
    cfg = serve.serve_config(args)
    log(f"serve: the daemon's config at --model base (C={C}, {H}x{W}, R={R}), models from phase "
        f"10's checkpoints through build_models (equal bit for bit); track.anchor_thresh "
        f"{cfg.track.anchor_thresh} replaced by phase 10's calibrated {ctx['anchor_thresh']:.6f}")
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(
        cfg.track, anchor_thresh=ctx["anchor_thresh"]))
    rates, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        frames = serve_queue(entries, data)
        work = {e: os.path.join(tmp, f"serve_{e}") for e in ("fused", "staged")}

        # (a) both engines, each against its direct calls, byte for byte
        recs, launches["fused"], peak_f = serve_engine(
            dev, kernels, "fused", data, work["fused"], models, cfg, frames,
            ("flow_level", "nms_grouped", "track_scan"))
        assert [(r["video"], r["engine"]) for r in recs] == [(n, "fused") for n in names], recs
        rates["fused"] = (recs, peak_f)
        engine = FusedEngine(models, cfg)
        direct = os.path.join(tmp, "direct_fused")
        for vid, box, fr in entries:
            det_proto, tubelets, _ = engine.run(vid, engine.load(vid, box, frames=fr))
            proto_dump(tubelets, os.path.join(direct, vid["video"], "tubelets.json"))
            proto_dump(det_proto, os.path.join(direct, vid["video"], "final.json"))
        got = tree_bytes(work["fused"])
        assert got == tree_bytes(direct), "serve --engine fused differs from FusedEngine"
        n_dets = [len(json.loads(got[f"{n}/final.json"])["detections"]) for n in names]
        n_tubes = [len(json.loads(got[f"{n}/tubelets.json"])["tracks"]) for n in names]
        assert min(n_dets) > 0

        recs, launches["staged"], peak_s = serve_engine(
            dev, kernels, "staged", data, work["staged"], models, cfg, frames,
            ("flow_level", "track_scan"))
        assert [(r["video"], r["engine"]) for r in recs] == [(n, "staged") for n in names], recs
        assert launches["staged"]["nms_grouped"] == 0, "the staged engine launched kernel B"
        rates["staged"] = (recs, peak_s)
        direct = os.path.join(tmp, "direct_staged")
        for vid, box, fr in entries:
            runner.run_video(direct, vid, box, models, cfg, frames=fr, device=dev)
        got_s = tree_bytes(work["staged"])
        assert got_s == tree_bytes(direct), "serve --engine staged differs from run_video"
        n_tracks = [len(json.loads(got_s[f"{n}/track.json"])["tracks"]) for n in names]
        log(f"serve: fused files == FusedEngine.load + run, staged files == run_video, byte for "
            f"byte, {len(names)} videos (fused final dets {n_dets}, tubelets {n_tubes}; staged "
            f"tracks {n_tracks}); launches fused {launches['fused']}, staged "
            f"{launches['staged']}")
        for w in work.values():
            left = [p for p in os.listdir(w) if p.endswith(".lock")]
            left += [p for n in names for p in os.listdir(os.path.join(w, n))
                     if p == "quarantine.json"]
            assert not left, f"serve left {left} in {w}"

        # resume: a second pass takes no video and writes nothing
        for label, w in work.items():
            stamps = tree_stamps(w)
            assert serve.serve_loop(data, w, models, cfg, engine=label, once=True, device=dev,
                                    frames=frames) == []
            assert tree_stamps(w) == stamps, f"a resumed {label} daemon wrote"

        # a video without proposals (the 50-frame one): the fused daemon hands it
        # to the staged engine
        vid0 = dict(entries[1][0], video="synth_nobox")
        det0 = dict(proto_load(os.path.join(work["staged"], names[1], "detect.json")),
                    video="synth_nobox")
        nobox = os.path.join(tmp, "data_nobox")
        fr_nb = serve_queue([(vid0, None, entries[1][2])], nobox, with_box=False)
        for w in ("serve_nobox", "direct_nobox"):  # the detect stage, as staged resume reads it
            proto_dump(det0, os.path.join(tmp, w, "synth_nobox", "detect.json"))
        recs = serve.serve_loop(nobox, os.path.join(tmp, "serve_nobox"), models, cfg,
                                engine="fused", once=True, device=dev, frames=fr_nb)
        assert [(r["video"], r["engine"]) for r in recs] == [("synth_nobox", "staged")], recs
        runner.run_video(os.path.join(tmp, "direct_nobox"), vid0, None, models, cfg,
                         frames=entries[1][2], device=dev)
        got_nb = tree_bytes(os.path.join(tmp, "serve_nobox"))
        assert got_nb == tree_bytes(os.path.join(tmp, "direct_nobox")) and \
            "synth_nobox/final.json" in got_nb, "the staged fallback differs from run_video"

        # a kernel error inside the fused engine leaves the daemon: no retry, no quarantine
        staged_calls = []
        real_run, real_run_video = FusedEngine.run, runner.run_video

        def failing_run(self, *a, **kw):
            FusedEngine.run = real_run
            raise KernelError("CUDA kernel nms_grouped failed to launch: cudaError 700 "
                              "(injected by chip_smoke.py)")

        def counted_run_video(*a, **kw):
            staged_calls.append(a[1]["video"])
            return real_run_video(*a, **kw)

        FusedEngine.run, runner.run_video = failing_run, counted_run_video
        kwork = os.path.join(tmp, "serve_kernel_error")
        try:
            serve.serve_loop(data, kwork, models, cfg, engine="fused", once=True, device=dev,
                             frames=frames)
        except KernelError:
            pass
        else:
            raise AssertionError("a KernelError inside the fused engine did not leave serve_loop")
        finally:
            FusedEngine.run, runner.run_video = real_run, real_run_video
        left = sorted(tree_bytes(kwork)) if os.path.isdir(kwork) else []
        assert staged_calls == [] and left == [], (staged_calls, left)
        log("serve: the resumed daemons took no video and wrote nothing; --engine fused served "
            "the video without proposals on the staged engine (== run_video, byte for byte); "
            "an injected KernelError left serve_loop with no staged retry, no quarantine and "
            "no lock")

        # (b) the host tools over the fused outputs
        m = host_tools(tmp, work["fused"], entries)

    for label, ref, ref_name in (("fused", ctx["fps"], "phase 10's fused sweep"),
                                 ("staged", ctx["staged_fps"], "phase 12's staged sweep")):
        recs, peak = rates[label]
        secs = sum(r["seconds"] for r in recs)
        fps = n_frames / secs
        log(f"serve --engine {label} on {card}: ms per video from lock to final.json "
            + ", ".join(f"{r['video']} ({r['frames']} frames) {r['seconds'] * 1e3:.1f}"
                        for r in recs)
            + f"; {fps:.2f} frames/s against {ref_name} {ref:.2f} ({fps / ref:.2f}x); peak "
            f"device memory {peak / 2**20:.1f} MiB")
    return {"launches": launches, "map": m}



# ---------------------------------------------------------------- phase 16


def one_rank_group():
    """A one-rank NCCL group through ``init_multihost``, from torch's
    environment (MASTER_ADDR 127.0.0.1, a free port, WORLD_SIZE 1, RANK 0)."""
    import os
    import socket

    import torch.distributed as dist

    from vdetlib_tpu_torch.dist import make_mesh
    from vdetlib_tpu_torch.dist.multihost import init_multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0")
    assert init_multihost(device="cuda"), "init_multihost started no group"
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    mesh = make_mesh()
    assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
    log(f"multihost: a one-rank NCCL group on port {port} (init_multihost from MASTER_ADDR, "
        f"MASTER_PORT, WORLD_SIZE, RANK), mesh {tuple(mesh.shape)} (data, model)")
    return mesh


def sharded_case(dev, kernels, mesh, cfg):
    """(a) make_sharded_pipeline over V = 2 of phase 5's snippets (64 frames
    and 50 padded to 64) at phase 5's config: bit-equal to the two single
    calls, with twice one call's launches of A, B and F."""
    from vdetlib_tpu_torch.pipeline.fused import make_fused_pipeline, make_sharded_pipeline

    det, trk, trk_cfg = base_models(dev)
    videos = [slice_inputs(T, seed) for seed, T in enumerate(VIDEO_LENGTHS[:2])]
    frames, rois, masks = (torch.stack([torch.from_numpy(v[i]) for v in videos]).to(dev)
                           for i in (0, 1, 3))
    t_valid = [v[2] for v in videos]
    single = make_fused_pipeline(det, trk, trk_cfg, cfg)
    sharded = make_sharded_pipeline(det, trk, trk_cfg, cfg, mesh)
    outs, counts, walls = [], [], []
    for v in range(2):
        torch.cuda.synchronize()
        zero_counts(kernels)
        t0 = time.perf_counter()
        outs.append(single(frames[v], rois[v], t_valid[v], masks[v]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append({n: fn.launches for n, fn in kernels.items()})
    zero_counts(kernels)
    t0 = time.perf_counter()
    got = sharded(frames, rois, t_valid, masks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels, "sharded pipeline (phase 16)",
                           ("flow_level", "nms_grouped", "track_scan"))
    for name in ("flow_level", "nms_grouped", "track_scan"):
        assert counts[0][name] == counts[1][name] and launches[name] == 2 * counts[0][name], \
            f"sharded pipeline: {name} launched {launches[name]} times, single calls {counts}"
    for field in got._fields:
        x = getattr(got, field)
        assert x.shape[0] == 2, field
        for v in range(2):
            assert torch.equal(x[v], getattr(outs[v], field)), \
                f"sharded pipeline: {field} of snippet {v} differs from its single call"
    log(f"sharded pipeline (V=2, phase 5's config and snippets of 64 and 50 frames, gathered "
        f"by NCCL's all_gather, bool fields as uint8): every field == the single calls bit for "
        f"bit; launches {launches} = 2 x one call's; wall "
        f"{wall * 1e3:.1f} ms against the single calls' {sum(walls) * 1e3:.1f} ms "
        f"({walls[0] * 1e3:.1f} + {walls[1] * 1e3:.1f}): {wall / sum(walls):.3f}x")
    return launches, wall / sum(walls)


def sharded_train_case(dev, mesh):
    """(b) One step of phase 14's base recipe (batch 8, 64 ROIs, augmentation,
    cosine) with ``mesh`` against ``train_step`` without one, same batch and
    state, cuDNN deterministic: gradients, parameters and loss terms within
    1e-6 of each tensor's largest; then 20 more steps of each, taken in
    turn and timed, and the gradient all-reduce alone."""
    from vdetlib_tpu_torch.cli.train_detector import BatchOptions
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.dist import shard_batch
    from vdetlib_tpu_torch.nn import train as ttrain
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.weights import init_detector

    sv = make_video(SynthConfig(num_frames=16, height=H, width=W, num_classes=C, seed=300))
    batch = ttrain.make_training_batch(sv, np.random.default_rng(0),
                                       BatchOptions(TRAIN_B, TRAIN_R, True), C)
    runs, steps = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for label, m in (("plain", None), ("sharded", mesh)):
        det = init_detector(detector_preset("base", num_classes=C),
                            torch.Generator().manual_seed(0), device=dev)
        det.train()
        opt = ttrain.make_optimizer(det.parameters(), TRAIN_LR, schedule="cosine",
                                    total_steps=TRAIN_STEPS)
        b = batch if m is None else shard_batch(m, batch)
        terms = ttrain.train_step(det, opt, b, mesh=m)
        torch.cuda.synchronize()
        runs[label] = dict(terms={k: float(v) for k, v in terms.items()},
                           grads=grads_of(det), ms=[],
                           params={n: p.detach().float().cpu() for n, p in det.named_parameters()})
        steps[label] = (functools.partial(ttrain.train_step, det, opt, mesh=m), b, det)
    for _ in range(20):  # in turn, so that the host's drift falls on both alike
        for label, (step, b, _) in steps.items():
            runs[label]["ms"] += timed_steps(step, [b])[1]
    for run in runs.values():
        run["ms"] = float(np.median(run["ms"][2:]))
    det, group = steps["sharded"][2], mesh.get_group("data")
    ar = cuda_ms(lambda: ttrain.allreduce_grads(det, group), 10)
    del steps, det
    torch.backends.cudnn.deterministic = deterministic
    worst = {k: compare_grads(f"sharded step {k}", runs["sharded"][k], runs["plain"][k], 1e-6)
             for k in ("grads", "params")}
    for k, v in runs["plain"]["terms"].items():
        assert abs(runs["sharded"]["terms"][k] - v) <= 1e-6 * max(abs(v), 1e-12), \
            f"sharded step: {k} {runs['sharded']['terms'][k]} against {v}"
    n_params = sum(p.numel() for p in runs["plain"]["params"].values())
    log(f"sharded train step (one rank, NCCL): loss {runs['sharded']['terms']['loss']:.6f} == "
        f"{runs['plain']['terms']['loss']:.6f}; gradients within {worst['grads']:.1e} and "
        f"parameters within {worst['params']:.1e} of their largest (bound 1e-6); "
        f"{runs['sharded']['ms']:.2f} ms a step against {runs['plain']['ms']:.2f} without the "
        f"mesh (medians of steps 4-21, the two taken in turn, CUDA events); the all-reduce of "
        f"the {n_params} float32 gradients alone {ar:.3f} ms (one call on their flat buffer; "
        f"scripts/sharded_step_probe.py splits it)")
    return runs["sharded"]["ms"] - runs["plain"]["ms"], ar


def multihost_sweep_case(dev, kernels, ctx):
    """(c) ``pipeline --multihost --engine fused`` over phase 10's videos from
    its checkpoints (frames in memory): each final.json and tubelets.json
    byte-equal to direct pipeline calls at the tool's config (phase 10's
    ``direct_protos``); ``allreduce_metrics`` returns its input."""
    import os
    import tempfile

    from vdetlib_tpu_torch.cli import pipeline_tool
    from vdetlib_tpu_torch.dist.multihost import allreduce_metrics
    from vdetlib_tpu_torch.pipeline.fused import make_fused_pipeline
    from vdetlib_tpu_torch.pipeline.fused_runner import fused_config_from_pipeline

    entries, ckpt = ctx["entries"], ctx["checkpoints"]
    names = [e[0]["video"] for e in entries]
    with tempfile.TemporaryDirectory() as tmp:
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        frames = serve_queue(entries, data)
        argv = [data, work, "--model", "base", "--num_classes", str(C), "--image_hw", str(H),
                str(W), "--max_rois", str(R), "--batch_size", str(B), "--max_tracks", str(A),
                "--anchor_thresh", repr(ctx["anchor_thresh"]), "--engine", "fused",
                "--detector_weights", ckpt["detector"], "--tracker_weights", ckpt["tracker"],
                "--multihost"]
        torch.cuda.synchronize()
        zero_counts(kernels)
        t0 = time.perf_counter()
        assert pipeline_tool.main(argv, frames=frames) == 0, "pipeline --multihost failed"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kernels, "pipeline --multihost (phase 16)",
                               ("flow_level", "nms_grouped", "track_scan"))
        cfg = pipeline_tool.pipeline_config(pipeline_tool.parse_args(argv))
        pipe = make_fused_pipeline(ctx["models"].detector, ctx["models"].tracker,
                                   cfg.tracker_cfg, fused_config_from_pipeline(cfg))
        videos = [slice_inputs(T, seed) for seed, T in enumerate(VIDEO_LENGTHS)]
        direct_protos(pipe, dev, videos, names, cfg.link.min_score, os.path.join(tmp, "direct"))
        for name in names:
            for f in ("final.json", "tubelets.json"):
                with open(os.path.join(work, name, f), "rb") as a, \
                        open(os.path.join(tmp, "direct", name, f), "rb") as b:
                    assert a.read() == b.read(), f"pipeline --multihost {name}/{f} differs"
    metrics = {"videos": float(len(names)), "frames": float(sum(VIDEO_LENGTHS))}
    assert allreduce_metrics(metrics) == metrics
    log(f"pipeline --multihost --engine fused (one rank): {len(names)} videos in {wall:.3f} s "
        f"({sum(VIDEO_LENGTHS) / wall:.2f} frames/s, the tool's 100 seq-NMS paths), final.json "
        f"and tubelets.json == direct pipeline calls at the tool's config, byte for byte; "
        f"allreduce_metrics returned its input")
    return launches


def mfu_case(card, slice_cfg, walls, fps):
    """(d) Phase 5's MFU: the analytic FLOPs of each call (the frames it
    processes, ``t_valid``, not its padded bucket) over its wall × the bf16
    tensor-core peak."""
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.utils import flops

    det_cfg, trk_cfg = detector_preset("base", num_classes=C), TrackerConfig()
    comps = [flops.fused_dispatch_flops(det_cfg, trk_cfg, slice_cfg, T, R)
             for T in VIDEO_LENGTHS]
    per_call = [flops.total_flops(c) for c in comps]
    mfus = [flops.mfu(f, w) for f, w in zip(per_call, walls)]
    share = sum(x.flops for x in comps[0] if x.unit == flops.MATMUL) / per_call[0]
    backbone = comps[0][0].flops / per_call[0]
    log(f"slice MFU on {card}: median {100 * float(np.median(mfus)):.4f}% of the "
        f"{flops.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak (per video "
        f"{', '.join(f'{100 * m:.4f}%' for m in mfus)}; "
        f"{per_call[0] / VIDEO_LENGTHS[0] / 1e9:.2f} GFLOP a frame, {per_call[0]:.4g} for "
        f"{VIDEO_LENGTHS[0]} frames, backbone {100 * backbone:.1f}%, matmul work "
        f"{100 * share:.1f}%), beside phase 5's {fps:.2f} frames/s")
    return float(np.median(mfus))


def trace_case(dev, slice_cfg):
    """(e) ``profiling.device_trace`` around one fused call of phase 5."""
    import os
    import tempfile

    from vdetlib_tpu_torch.pipeline.fused import make_fused_pipeline
    from vdetlib_tpu_torch.utils import profiling

    pipe = make_fused_pipeline(*base_models(dev), slice_cfg)
    frames, rois, t_valid, roi_mask, _ = slice_inputs(VIDEO_LENGTHS[0], 0)
    args = [torch.from_numpy(a).to(dev) for a in (frames, rois, roi_mask)]
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            pipe(args[0], args[1], t_valid, args[2])
        path = os.path.join(tmp, profiling.TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    names = {e.get("name") for e in events}
    assert "fused.seq_nms" in names, "the trace names no fused.seq_nms span"
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    log(f"device_trace: {size} bytes, {len(events)} events ({n_kernels} device kernels), spans "
        f"{sorted(n for n in names if n and n.startswith('fused.'))}")


def native_nms_case():
    """(f) ``frame_nms --backend host`` at 512 boxes: the native library's keep
    sets against the numpy greedy's."""
    import vdetlib_tpu_torch.video.frame_nms as fnms
    from vdetlib_tpu_torch.kernels.nms import nms_host, nms_host_plain

    vid, det = frame_nms_protos(NMS_FRAMES, 512, seed=512)
    t0 = time.perf_counter()
    got = fnms.frame_nms(vid, det, thresh=0.3, backend="host")
    t1 = time.perf_counter()
    fnms.nms_host = nms_host_plain
    try:
        want = fnms.frame_nms(vid, det, thresh=0.3, backend="host")
    finally:
        fnms.nms_host = nms_host
    t2 = time.perf_counter()
    assert 0 < len(got["detections"]) < len(det["detections"])
    assert got == want, "frame_nms host: the native keep sets differ from the numpy greedy's"
    log(f"frame_nms --backend host at <= 512 dets/frame ({len(det['detections'])} in, "
        f"{len(got['detections'])} out): native (csrc/nms_host.cpp) == numpy greedy; native "
        f"{(t1 - t0) * 1e3:.1f} ms, numpy {(t2 - t1) * 1e3:.1f} ms wall (PERF.md section 5: "
        f"389.2-1186.2 ms for the numpy host backend, PRs 2-11)")
    return (t1 - t0) * 1e3


def phase_multihost(dev, kernels, card, slice_cfg, slice_walls, slice_fps, sweep_ctx):
    """Phase 16: data parallelism on a one-rank NCCL group, the MFU line, a
    trace and the native host NMS; returns A's, B's and F's launches."""
    import os

    import torch.distributed as dist

    mesh = one_rank_group()
    try:
        sharded, ratio = sharded_case(dev, kernels, mesh, slice_cfg)
        torch.cuda.synchronize()
        step_added_ms, allreduce_ms = sharded_train_case(dev, mesh)
        torch.cuda.synchronize()
        sweep = multihost_sweep_case(dev, kernels, sweep_ctx)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            os.environ.pop(k, None)
    mfu = mfu_case(card, slice_cfg, slice_walls, slice_fps)
    trace_case(dev, slice_cfg)
    torch.cuda.synchronize()
    native_ms = native_nms_case()
    return dict(launches={"sharded": sharded, "multihost_sweep": sweep}, sharded_ratio=ratio,
                step_added_ms=step_added_ms, allreduce_ms=allreduce_ms, mfu=mfu,
                native_ms=native_ms)


def rank_by_device_loss(records, slice_counts, stream_counts, nms_counts, staged_counts):
    """Ranks kernels B–E by their device loss over phases 5–8: launches ×
    (device ms − bound ms), B at its fused shape for the slice's launches and
    at the stream's for the stream's, D at the frame-NMS tool's own problems
    (phase 7 launches it at 512 and 1,024 slots). A kernel is a candidate
    for a redesign while it reaches less than half its bound (E also while
    its library call is faster); the two candidates that lose most are
    named."""
    b = records["nms_grouped"]["shapes"]
    e = records["resize_normalize"]
    terms = {
        "nms_grouped": [(slice_counts["nms_grouped"], b["fused"]),
                        (stream_counts["nms_grouped"], b["stream"])],
        "nms_batched": [(stream_counts["nms_batched"] + nms_counts["nms_batched"],
                         records["nms_batched"])],
        "nms_sorted": [(nms_counts["nms_sorted"], records["nms_sorted"]["shapes"]["tool"])],
        "resize_normalize": [(staged_counts["resize_normalize"], e)],
    }
    losses = {}
    for name, parts in terms.items():
        losses[name] = sum(n * (r["device_ms"] - r["bound_ms"]) for n, r in parts)
        records[name]["device_loss_ms"] = losses[name]
    slow = {name for name, parts in terms.items()
            if any(r["device_ms"] > 2 * r["bound_ms"] for _, r in parts)}
    if e["device_ms"] > e["library_device_ms"]:
        slow.add("resize_normalize")
    order = sorted(losses, key=losses.get, reverse=True)
    log("device loss over phases 5-8, launches x (device ms - bound ms): "
        + ", ".join(f"{n} {losses[n]:.4f} ms" for n in order)
        + f"; under half their bound: {sorted(slow)}; the two that lose most: "
        + ", ".join([n for n in order if n in slow][:2]))


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
    from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_kernel
    from vdetlib_tpu_torch.kernels.track_scan import track_scan_kernel
    from vdetlib_tpu_torch.video.stream import StreamOptions

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    for name in (*build.KERNELS, *build.HOST_LIBS):
        build.load(name)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(build.KERNELS)} kernels and {len(build.HOST_LIBS)} host library in "
        f"parallel, {time.perf_counter() - t0:.2f} s")

    records = phase_kernels(dev)
    torch.cuda.synchronize()
    assert records["nms_sorted"]["device_kernels_per_call"] == 1, \
        "kernel D's call ran more than its one kernel on the device"
    phase_reference(dev)
    torch.cuda.synchronize()
    kernels = {"flow_level": flow_level, "nms_grouped": nms_grouped_kernel,
               "nms_batched": nms_batched_kernel, "nms_sorted": nms_sorted_kernel,
               "resize_normalize": fused_resize_normalize_kernel,
               "track_scan": track_scan_kernel, "seq_nms": seq_nms_kernel}
    slice_counts, fps, steady, peak, slice_ctx = phase_slice(dev, kernels, args.profile)
    torch.cuda.synchronize()
    log(f"slice throughput on {card}: {fps:.2f} frames/s overall, {steady:.2f} frames/s "
        f"steady; peak memory {peak / 2**20:.1f} MiB")
    stream_models = base_models(dev)
    stream_counts, sfps, ssteady, chunk_ms, speak, stream_ctx = phase_stream(
        dev, kernels, stream_models, StreamOptions(), args.profile)
    torch.cuda.synchronize()
    log(f"stream throughput on {card}: {sfps:.2f} frames/s overall, {ssteady:.2f} after the "
        f"first chunk, {chunk_ms:.1f} ms per full chunk; peak memory {speak / 2**20:.1f} MiB")
    nms_counts = phase_frame_nms(dev, kernels)
    torch.cuda.synchronize()
    staged_counts, staged_ctx = phase_staged(dev, kernels, args.profile)
    torch.cuda.synchronize()
    phase_stream_engines(kernels, stream_models, stream_ctx)
    torch.cuda.synchronize()
    ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")  # phases 10 and 15
    _, sweep_ctx = phase_sweep(dev, kernels, slice_ctx, fps, card, ckpt_dir.name)
    torch.cuda.synchronize()
    slice_cfg, stream_opts, slice_walls = slice_ctx["cfg"], stream_ctx["opts"], slice_ctx["walls"]
    del stream_models, stream_ctx, slice_ctx
    chain_counts = phase_staged_chain(dev, kernels, staged_ctx, records["flow_level"])
    torch.cuda.synchronize()
    del staged_ctx
    sweep_counts = phase_staged_sweep(dev, kernels, sweep_ctx, card)
    torch.cuda.synchronize()
    t13 = time.perf_counter()
    options = phase_options(dev, kernels, card, slice_cfg, fps, sweep_ctx, stream_opts, records)
    torch.cuda.synchronize()
    log(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    training = phase_training(dev, kernels, card)
    torch.cuda.synchronize()
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    served = phase_serve(dev, kernels, sweep_ctx, card)
    torch.cuda.synchronize()
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    multihost = phase_multihost(dev, kernels, card, slice_cfg, slice_walls, fps, sweep_ctx)
    torch.cuda.synchronize()
    ckpt_dir.cleanup()
    log(f"phase 16 took {time.perf_counter() - t16:.1f} s")

    own_path = {"flow_level": slice_counts, "nms_grouped": slice_counts,
                "nms_batched": stream_counts, "nms_sorted": nms_counts,
                "resize_normalize": staged_counts, "track_scan": staged_counts,
                "seq_nms": slice_counts}
    for name, rec in records.items():
        rec["launches"] = own_path[name][name]
    records["flow_level"]["launches_staged_chain"] = chain_counts["flow_level"]
    for name in ("flow_level", "track_scan"):
        records[name]["launches_staged_sweep"] = sweep_counts[name]
        records[name]["launches_options"] = options["launches"][name]  # phase 13, EMA run
    records["track_scan"]["options_plain_ms"] = options["scan"]
    records["nms_batched"]["launches_train"] = training["launches"]  # phase 14's eval
    for name in ("flow_level", "nms_grouped", "track_scan"):  # phase 15, by engine
        records[name]["launches_serve"] = {e: n[name] for e, n in served["launches"].items()}
        # phase 16: the sharded pipeline and pipeline --multihost
        records[name]["launches_multihost"] = {
            k: n[name] for k, n in multihost["launches"].items()}
    rank_by_device_loss(records, slice_counts, stream_counts, nms_counts, staged_counts)
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
