"""A traced part of a run, reduced in memory to what the per-layer readers read.

The part runs under ``torch.profiler`` (host and CUDA activity) inside a
``portbench.window`` span. Its raw events (never exported) reduce to:

- ``window_s``: the span's length; ``busy_s``: the union of the device
  operations' intervals (kernels, copies, sets) within it;
- for each program span name (``fused.*``, ``stream.*``): ``span_wall_s``,
  the union of its host intervals, and ``span_device_s``, the device time
  of every operation launched while the span was open on the launching
  thread, whatever the operation is called;
- ``breakdown``: the device operations that took most time, and the longest
  idle gaps of the device, each named by the innermost span open on the
  host at the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW = "portbench.window"
LAUNCH_PREFIX = "cuda_"  # the CUDA API calls on the host that launch work
NAME_CHARS = 120  # a kernel's name in the breakdown: its first characters


def _kind(e) -> str:
    """An event's kind, from its device, its annotation flag and the runtime
    API's names: ``user_annotation`` (a span on the host), ``cuda_runtime``
    (a launch on the host), ``kernel`` (any operation on the card) or
    ``cpu_op``."""
    if e.is_user_annotation():
        return "user_annotation" if str(e.device_type()).endswith("CPU") else "gpu_annotation"
    if str(e.device_type()).endswith("CUDA"):
        return "kernel"
    if e.name().startswith(("cuda", "cu")) and e.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


def capture(fn):
    """Run ``fn()`` traced → (its result, the reduced trace).
    Without a card only the host is traced (the CPU tests' dry runs)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            result = fn()
            if cuda:
                torch.cuda.synchronize()
    return result, reduce_events(prof.profiler.kineto_results.events())


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def reduce_events(events) -> dict:
    """Raw profiler events → the reduced trace (see the module docstring)."""
    spans = defaultdict(list)  # name → [(start, end, tid)]
    launches = []  # (start, tid, correlation)
    device = []  # (start, end, name, correlation)
    for e in events:
        kind = _kind(e)
        if kind == "user_annotation":
            spans[e.name()].append((e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif kind.startswith(LAUNCH_PREFIX):
            launches.append((e.start_ns(), e.start_thread_id(), e.correlation_id()))
        elif kind == "kernel":
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    if WINDOW not in spans:
        raise RuntimeError("the trace holds no window span")
    # device-side copies of the host spans are ranges, not operations
    device = [d for d in device if d[2] not in spans]
    w0, w1, main_tid = spans.pop(WINDOW)[0]
    dev_by_corr = defaultdict(float)
    by_name = defaultdict(float)
    intervals = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        dur = (e - s) * 1e-9
        dev_by_corr[corr] += dur
        by_name[name[:NAME_CHARS]] += dur
        intervals.append((s, e))
    busy = _union(intervals)
    launches.sort()
    l_times = [x[0] for x in launches]

    span_wall, span_dev = {}, {}
    for name, ivs in spans.items():
        own = _clip([(s, e) for s, e, _ in ivs], w0, w1)
        span_wall[name] = sum(e - s for s, e in _union(own)) * 1e-9
        dev = 0.0
        for s, e, tid in ivs:
            for i in range(bisect.bisect_left(l_times, s), bisect.bisect_right(l_times, e)):
                if launches[i][1] == tid:
                    dev += dev_by_corr.get(launches[i][2], 0.0)
        span_dev[name] = dev

    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    main = sorted((s, e, n) for n, ivs in spans.items() for s, e, t in ivs if t == main_tid)
    labelled = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        best = None
        for ss, se, n in main:
            if ss > mid:
                break
            if se >= mid and (best is None or ss >= best[0]):
                best = (ss, n)
        labelled[best[1] if best else "host"] += (e - s) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "span_wall_s": span_wall,
        "span_device_s": span_dev,
        "n_device_ops": len(device),
        "breakdown": {
            "device_ops": sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, v] for n, v in labelled.items()), key=lambda x: -x[1])[:10],
        },
    }
