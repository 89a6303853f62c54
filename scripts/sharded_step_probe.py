#!/usr/bin/env python3
"""Where the data-parallel detector step's extra time goes (on a card).

    python3 scripts/sharded_step_probe.py [--rounds 40]

Starts a one-rank NCCL group (``init_multihost`` from MASTER_ADDR,
MASTER_PORT, WORLD_SIZE and RANK on a free local port), times ``make_mesh``
(which connects its groups) and a first collective on the new mesh, then
takes ``chip_smoke.py`` phase 14's ``base`` step (C = 31, 240×320, batch 8,
64 ROIs, augmentation) in three forms, one after another for ``--rounds``
rounds: without a mesh; with one, as ``train_step`` takes it (the gradients
are views of one flat buffer, summed by one all-reduce); and with the
flatten-and-copy-back all-reduce that the buffer replaced (``torch.cat`` of
the gradients, the NCCL call, a copy back into each). Prints each form's
median ms a step (CUDA events), each all-reduce alone and the old one's
parts, the device time of one all-reduce of each form by part
(torch.profiler), and the host time that ``backward`` takes to enqueue with
and without the buffer. The three forms' parameters must stay bit-equal.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flatten_allreduce(model, group):
    """The all-reduce that the flat buffer replaced: flatten, sum, copy back."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def flatten_step(model, opt, batch, group):
    from vdetlib_tpu_torch.nn.train import loss_and_terms

    dev = next(model.parameters()).device
    b = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_and_terms(model, b, group=group)
    loss.backward()
    flatten_allreduce(model, group)
    opt.step()
    return dict(aux, loss=loss.detach())


def by_part(recs, iters):
    parts = {}
    for name, us in recs:
        low = name.lower()
        kind = ("nccl" if "nccl" in low else "flatten" if "cat" in low
                else "copy-back" if "copy" in low or "memcpy" in low else "other")
        parts[kind] = parts.get(kind, 0.0) + us / iters / 1e3
    return ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(parts.items()))


def backward_enqueue_ms(model, batch, group, reset, n=15):
    """Median host ms that ``loss.backward()`` takes to return (its launches)."""
    from vdetlib_tpu_torch.nn.train import loss_and_terms

    dev = next(model.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}
    ms = []
    for _ in range(n):
        reset()
        loss, _ = loss_and_terms(model, b, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(ms[3:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sharded_step_probe: no CUDA device", file=sys.stderr)
        return 1
    import functools

    import chip_smoke as cs
    from vdetlib_tpu_torch.cli.train_detector import BatchOptions
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
    from vdetlib_tpu_torch.dist import make_mesh, shard_batch
    from vdetlib_tpu_torch.nn import train as ttrain
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.weights import init_detector

    dev = torch.device("cuda", 0)
    print(f"{cs.gpu_name_and_power()} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    mesh = cs.one_rank_group()
    print(f"init_multihost + make_mesh: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh2 = make_mesh()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x = torch.zeros(1, device=dev)
    dist.all_gather([torch.empty_like(x)], x, group=mesh2.get_group("data"))
    torch.cuda.synchronize()
    print(f"a second make_mesh: {(t1 - t0) * 1e3:.1f} ms; its first all_gather "
          f"{(time.perf_counter() - t1) * 1e3:.2f} ms")

    group = mesh.get_group("data")
    sv = make_video(SynthConfig(num_frames=16, height=cs.H, width=cs.W, num_classes=cs.C,
                                seed=300))
    batch = shard_batch(mesh, ttrain.make_training_batch(
        sv, np.random.default_rng(0), BatchOptions(cs.TRAIN_B, cs.TRAIN_R, True), cs.C))
    forms = {}
    for label in ("no mesh", "flat buffer", "flatten + copy-back"):
        det = init_detector(detector_preset("base", num_classes=cs.C),
                            torch.Generator().manual_seed(0), device=dev).train()
        opt = ttrain.make_optimizer(det.parameters(), cs.TRAIN_LR, schedule="cosine",
                                    total_steps=cs.TRAIN_STEPS)
        step = {"no mesh": functools.partial(ttrain.train_step, det, opt),
                "flat buffer": functools.partial(ttrain.train_step, det, opt, mesh=mesh),
                "flatten + copy-back": functools.partial(flatten_step, det, opt,
                                                         group=group)}[label]
        forms[label] = dict(step=step, det=det, ms=[])
    for _ in range(args.rounds):
        for form in forms.values():
            form["ms"] += cs.timed_steps(form["step"], [batch])[1]
    params = {k: list(f["det"].parameters()) for k, f in forms.items()}
    for k in ("flat buffer", "flatten + copy-back"):
        assert all(torch.equal(p, q) for p, q in zip(params[k], params["no mesh"])), k
    for k, f in forms.items():
        v = np.array(f["ms"][3:])
        print(f"{k}: {np.median(v):.3f} ms a step (median of rounds 4-{args.rounds}; quartiles "
              f"{np.percentile(v, 25):.3f}-{np.percentile(v, 75):.3f})")
    print(f"parameters after {args.rounds} steps of each: bit-equal")

    flat_det, old_det = forms["flat buffer"]["det"], forms["flatten + copy-back"]["det"]
    grads = [p.grad for p in old_det.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    parts = flat.split([g.numel() for g in grads])

    def copy_back():
        for g, part in zip(grads, parts):
            g.copy_(part.view_as(g))

    print(f"flatten + copy-back all-reduce of {len(grads)} gradients "
          f"({flat.numel()} float32): "
          f"{cs.cuda_ms(lambda: flatten_allreduce(old_det, group), 10):.3f} ms; alone: flatten "
          f"{cs.cuda_ms(lambda: torch.cat([g.reshape(-1) for g in grads]), 10):.3f}, NCCL "
          f"{cs.cuda_ms(lambda: dist.all_reduce(flat, group=group), 10):.3f}, copy-back "
          f"{cs.cuda_ms(copy_back, 10):.3f} ms; device of one call: "
          + by_part(cs.device_records(lambda: flatten_allreduce(old_det, group), 3), 3))
    marker = torch.zeros(1, device=dev)

    def flat_call():
        ttrain.allreduce_grads(flat_det, group)
        marker.fill_(1.0)  # a known kernel: a trace without it was lost, not idle

    recs = [r for r in cs.device_records(flat_call, 3, kernel="FillFunctor")
            if "FillFunctor" not in r[0]]
    print(f"flat-buffer all-reduce: "
          f"{cs.cuda_ms(lambda: ttrain.allreduce_grads(flat_det, group), 10):.3f} ms; device "
          f"of one call: {len(recs) / 3:.0f} activities"
          + (f", {by_part(recs, 3)}" if recs else ""))

    def drop_grads():
        for p in old_det.parameters():
            p.grad = None

    print(f"backward's host enqueue: {backward_enqueue_ms(old_det, batch, group, drop_grads):.3f}"
          f" ms stealing new gradients, "
          f"{backward_enqueue_ms(flat_det, batch, group, ttrain.flat_grads(flat_det).zero_):.3f}"
          f" ms adding into the buffer's views")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
