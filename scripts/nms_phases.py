#!/usr/bin/env python3
"""Where kernels B, C and D spend their time on the card, phase by phase, from a debug build.

    python3 scripts/nms_phases.py [--iters 20] [--kernels nms_grouped nms_batched nms_sorted]

Compiles ``csrc/nms_grouped.cu``, ``csrc/nms_batched.cu`` and
``csrc/nms_sorted.cu`` with ``-DVDET_NMS_PHASE_CLOCKS`` (beside the main
build in ``vdetlib_tpu_torch/_build/``; the main path never loads it), runs
each through its wrapper at the shapes ``chip_smoke.py`` phase 3 times (B:
256 × 192 slots in 30 groups, 32 × 192 and 960 × 192 in one group; C: 960 ×
64; D: 1,920 × 512 dense and from the frame-NMS tool's protos, 1,920 ×
2,048), and prints the clock64() cycles a block spends per phase (B, C: load
and compact, rank, scatter, adjacency, Jacobi steps, write back; D: load
and compact, sort and gather, walk, write), averaged over the blocks of the
launches, beside the launch's time by CUDA events and the card's name,
power limit and SM clock (nvidia-smi). A phase ends at the barrier after
it, so it counts the block's slowest warp; D's blocks with no valid slot
count in none of its phases, and its blocks of <= 32 valid slots run the
sort, walk and write on one warp, with no barrier.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from vdetlib_tpu_torch.kernels import build  # noqa: E402
from vdetlib_tpu_torch.kernels import nms_batched as kc  # noqa: E402
from vdetlib_tpu_torch.kernels import nms_grouped as kb  # noqa: E402
from vdetlib_tpu_torch.kernels import nms_sorted as kd  # noqa: E402

PHASES = {"nms_grouped": ("load", "rank", "scatter", "adjacency", "jacobi", "write"),
          "nms_batched": ("load", "rank", "scatter", "adjacency", "jacobi", "write"),
          "nms_sorted": ("load", "sort", "walk", "write")}


def debug_library(name):
    """Kernel ``name`` built with its phase counters: (entry, clock reader)."""
    so = build.BUILD_DIR / f"lib{name}_phases.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (_, extra) = build.KERNELS[name]
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-DVDET_NMS_PHASE_CLOCKS",
           "-o", str(so), str(build.CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    ((symbol, argtypes), _) = build.KERNELS[name]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    clocks = lib.vdet_nms_phase_clocks
    clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks.restype = ctypes.c_int
    return fn, clocks


def phase_cycles(name, call, blocks, iters):
    """(ms a launch by CUDA events, cycles a block per phase) of ``call``
    with kernel ``name``'s debug library."""
    fn, clocks = debug_library(name)
    orig = build.load
    build.load = lambda n: fn if n == name else orig(n)
    try:
        call()
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * 8)()
        build.check_launch("phase clocks", clocks(host, 1))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        build.check_launch("phase clocks", clocks(host, 1))
    finally:
        build.load = orig
    return (start.elapsed_time(end) / iters,
            [host[k] / (iters * blocks) for k in range(len(PHASES[name]))])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", nargs="+", default=sorted(PHASES), choices=sorted(PHASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_phases: no CUDA device; the kernels run only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"card: {chip_smoke.gpu_name_and_power()}, SM clock {clock}", flush=True)
    th = chip_smoke.NMS_THRESH
    cases = []
    for i, (label, Bn, N, n_groups) in enumerate(chip_smoke.GROUPED_SHAPES):
        a = [torch.from_numpy(x).to(dev)
             for x in chip_smoke.nms_problem(Bn, N, seed=1 + 10 * i, groups=max(n_groups, 1))]
        if n_groups == 1:
            a[3] = torch.zeros_like(a[3])
        cases.append((f"B {label} ({Bn}, {N}, {n_groups} groups)", "nms_grouped", Bn,
                      lambda a=a: kb.nms_grouped_kernel(*a, th)))
    a = [torch.from_numpy(x).to(dev) for x in chip_smoke.nms_problem(32 * 30, 64, seed=2)]
    cases.append(("C (960, 64)", "nms_batched", 960, lambda a=a: kc.nms_batched_kernel(*a, th)))
    for label, Bn, N, source in chip_smoke.SORTED_SHAPES:
        arrs = (chip_smoke.nms_problem(Bn, N, seed=3) if source == "nms_problem"
                else chip_smoke.frame_nms_problems(Bn // 30, N, seed=N))
        a = [torch.from_numpy(x).to(dev) for x in arrs]
        cases.append((f"D {label} ({Bn}, {N})", "nms_sorted", Bn,
                      lambda a=a: kd.nms_sorted_kernel(*a, th)))
    for label, name, blocks, call in cases:
        if name not in args.kernels:
            continue
        ms, cyc = phase_cycles(name, call, blocks, args.iters)
        total = sum(cyc)
        print(f"{label}: {ms:.4f} ms a launch (debug build); cycles a block: "
              + ", ".join(f"{p} {c:.0f} ({c / total:.0%})" for p, c in zip(PHASES[name], cyc))
              + f"; total {total:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
