#!/usr/bin/env python
"""Where kernel F's time goes on the card, phase by phase, from a debug build.

    python scripts/track_scan_phases.py [--iters 5] [--cold]

Compiles ``vdetlib_tpu_torch/csrc/track_scan.cu`` with
``-DTRACK_SCAN_PHASE_CLOCKS`` (beside the main build in
``vdetlib_tpu_torch/_build/``; the main path never loads it), runs the round
that ``chip_smoke.py`` phase 3 times (the base tracker's features of every
2nd frame of the staged 360×480 video: 48 × 90×120×96 bf16, A = 8 anchors at
seeded frames, default pools Q = 16, P = 8), and prints block 0's clock64()
counts per phase and step (taps, pooling, wait at barrier 1, correlation,
wait at barrier 2, soft-argmax and update), in cycles and in µs at the clock
implied by the launch's CUDA-event time, beside the card's name, power limit
and SM clock (nvidia-smi). ``--cold`` evicts the L2 cache before every
launch (each round then first touches its features in device memory, as a
round on newly computed features does). The round is timed twice.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from vdetlib_tpu_torch.kernels import build  # noqa: E402
from vdetlib_tpu_torch.kernels import track_scan as kf  # noqa: E402
from vdetlib_tpu_torch.nn.tracker_net import extract_template  # noqa: E402

PHASES = ("taps", "pooling", "barrier 1", "correlation", "barrier 2", "update")


def debug_library():
    """The kernel built with its phase counters, loaded with the main entry's
    types."""
    so = build.BUILD_DIR / "libtrack_scan_phases.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (_, extra) = build.KERNELS["track_scan"]
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-DTRACK_SCAN_PHASE_CLOCKS",
           "-o", str(so), str(build.CSRC_DIR / "track_scan.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    ((symbol, argtypes), _) = build.KERNELS["track_scan"]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    clocks = lib.vdet_track_scan_phase_clocks
    clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks.restype = ctypes.c_int
    return fn, clocks, res.stdout + res.stderr


def phase_clocks(fn, clocks, run_args, iters, flush=None):
    """(ms a launch, per-phase clocks of block 0's thread 0, steps) of the
    debug library ``fn``, called through the wrapper; with ``flush`` (a
    tensor larger than the L2 cache), overwritten before each launch, each
    launch finds the features in device memory, as a round on new features
    does."""
    orig = build.load
    build.load = lambda name: fn if name == "track_scan" else orig(name)
    try:
        kf.track_scan_kernel(*run_args)  # warm-up
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * 7)()
        build.check_launch("phase clocks", clocks(host, 1))
        total = 0.0
        for _ in range(iters):
            if flush is not None:
                flush.add_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            kf.track_scan_kernel(*run_args)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        build.check_launch("phase clocks", clocks(host, 0))
    finally:
        build.load = orig
    return total / iters, list(host[:6]), host[6]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cold", action="store_true",
                    help="evict the L2 cache (a 256 MiB write) before every launch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("track_scan_phases: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    fn, clocks, log = debug_library()
    _, trk, cfg = chip_smoke.base_models(dev)
    sv = chip_smoke.staged_video(chip_smoke.NATIVE_HW)
    with torch.no_grad():
        feats = chip_smoke.staged_features(trk, sv.frames, dev)
    Ts = feats.shape[0]
    rng = np.random.default_rng(7)
    ats = rng.integers(0, Ts, chip_smoke.A)
    k = rng.integers(0, sv.gt_boxes.shape[0], chip_smoke.A)
    boxes = (sv.gt_boxes[k, 2 * ats] + rng.normal(0, 3, (chip_smoke.A, 4))).astype(np.float32)
    ats = torch.as_tensor(ats, device=dev)
    boxes = torch.as_tensor(boxes, device=dev)
    run_args = (feats, ats, boxes, extract_template(feats[ats], boxes, cfg), cfg, 0.5)
    sm_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    print(f"device: {chip_smoke.gpu_name_and_power()}, SM clock {sm_clock} (nvidia-smi)")
    Q, P, C = cfg.search_pool, cfg.template_pool, feats.shape[-1]
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device=dev) if args.cold else None
    for _ in range(2):
        ms, clk, steps = phase_clocks(fn, clocks, run_args, args.iters, flush)
        total = sum(clk)
        mhz = total / (ms * 1e3 * args.iters)  # cycles per µs of the event-timed launches
        regs, spill = chip_smoke.ptxas_usage(
            log, f"track_scan_kernelI13__nv_bfloat16Lb1ELi{Q}ELi{P}ELi{C}E")
        print(f"debug build{', L2 evicted before each launch' if args.cold else ''}, "
              f"{Ts} steps x {2 * chip_smoke.A} lanes over {tuple(feats.shape)}: {ms:.4f} ms a "
              f"launch (CUDA events, {args.iters} launches) = {ms * 1e3 / Ts:.2f} us a step; "
              f"block 0: {total / steps:.0f} cycles a step ({mhz:.0f} cycles/us); {regs} "
              f"registers, {spill} bytes spilled")
        for name, c in zip(PHASES, clk):
            print(f"  {name:12s} {c / steps:9.0f} cycles a step  {c / steps / mhz:7.3f} us  "
                  f"{100.0 * c / total:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
