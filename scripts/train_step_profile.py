#!/usr/bin/env python3
"""Where a training step's device time goes, kernel by kernel (on a card).

    python3 scripts/train_step_profile.py [--trainer detector|pair|aware]
        [--model base] [--batch 8] [--rois 64] [--hw 240 320] [--top 25]

Builds the trainer's model with seeded random weights, takes ``--warmup``
steps, then traces ``--iters`` steps with torch.profiler (CUPTI) and prints
the device time a step of the ``--top`` kernels, each with its launches a
step, the device's total and idle share of the wall a step (CUDA events),
and the same time grouped by the op that launched each kernel, under the
autograd node it ran in (``XBackward0 / aten::op``) or in the forward or
the optimizer (``aten::op``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def detector_step(args, dev):
    from vdetlib_tpu_torch.cli.train_detector import BatchOptions
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.nn import train as ttrain
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.weights import init_detector

    C = args.num_classes
    sv = make_video(SynthConfig(num_frames=16, height=args.hw[0], width=args.hw[1],
                                num_classes=C, seed=300))
    batch = ttrain.make_training_batch(sv, np.random.default_rng(0),
                                       BatchOptions(args.batch, args.rois, True), C)
    det = init_detector(detector_preset(args.model, num_classes=C),
                        torch.Generator().manual_seed(0), device=dev).train()
    opt = ttrain.make_optimizer(det.parameters(), 1e-3)
    return lambda: ttrain.train_step(det, opt, batch)


def tracker_step(args, dev):
    from vdetlib_tpu_torch.data.synth import SynthConfig, hard_config, make_video
    from vdetlib_tpu_torch.nn import tracker_train as ttt
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.weights import init_tracker

    cfg = TrackerConfig()
    mk = hard_config if args.trainer == "aware" else SynthConfig
    videos = [make_video(mk(num_frames=24, height=args.hw[0], width=args.hw[1], seed=400 + i))
              for i in range(3)]
    rng = np.random.default_rng(0)
    batch = (ttt.make_tracker_batch_aware(videos, rng, args.batch, cfg) if args.trainer == "aware"
             else ttt.make_tracker_batch(videos, rng, args.batch))
    trk = init_tracker(cfg, torch.Generator().manual_seed(1), device=dev).train()
    opt = ttt.make_tracker_optimizer(trk)
    return lambda: ttt.tracker_train_step(trk, cfg, opt, batch, args.trainer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trainer", default="detector", choices=["detector", "pair", "aware"])
    ap.add_argument("--model", default="base", choices=["base", "small", "tiny"])
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rois", type=int, default=64)
    ap.add_argument("--hw", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    step = detector_step(args, dev) if args.trainer == "detector" else tracker_step(args, dev)
    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        step()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / args.iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
    kernels, launches, by_op = {}, {}, {}
    events = prof.events()
    for e in events:
        # a record_function range on the device's timeline (Optimizer.step#...)
        # spans kernels listed on their own
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us() / args.iters
        kernels[e.name] = kernels.get(e.name, 0.0) + us
        launches[e.name] = launches.get(e.name, 0) + 1
    # the op that launched each kernel, under its autograd node if any
    for e in events:
        if e.device_type == DeviceType.CUDA or not e.kernels:
            continue
        node, p = None, e.cpu_parent
        while p is not None and node is None:
            node = p.name.split(": ")[-1] if "Backward" in p.name else None
            p = p.cpu_parent
        label = f"{node} / {e.name}" if node else e.name
        us = sum(k.duration for k in e.kernels) / args.iters
        by_op[label] = by_op.get(label, 0.0) + us
    busy = sum(kernels.values()) / 1e3
    name = f"{args.trainer} ({args.model})" if args.trainer == "detector" else args.trainer
    print(f"{torch.cuda.get_device_name(0)}: {name} step, batch {args.batch}, "
          f"{args.hw[0]}x{args.hw[1]}: wall {wall:.2f} ms a step (CUDA events), device "
          f"{busy:.2f} ms (idle {max(0.0, 1 - busy / wall):.0%}), "
          f"{sum(launches.values()) / args.iters:.0f} device activities a step")
    print("top kernels (device ms a step, launches a step):")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {v / 1e3:8.3f} ms {launches[k] / args.iters:6.1f}  {k[:110]}")
    print("by the op that launched them (device ms a step):")
    for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {v / 1e3:8.3f} ms  {k[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
