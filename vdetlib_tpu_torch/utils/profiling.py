"""Tracing and timing helpers — the port's copy of ``vdetlib_tpu/utils/profiling.py``.

:func:`device_trace` records a ``torch.profiler`` trace (host and, where a
card is present, CUDA activity) into a directory as a Chrome trace, which
Perfetto opens; the pipeline's ``record_function`` spans (``fused.<stage>``,
``stream.<stage>``, ``track.<stage>``) name its ranges. The stage timers
synchronise the device the tensors live on, so a wall time covers the
device's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from vdetlib_tpu_torch.utils.log import get_logger

log = get_logger("profiling")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` into ``trace_dir/trace.json``.

    No-op when ``trace_dir`` is None, so callers can leave the hook in place.
    Records CUDA activity too where a card is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:  # the block's device work ends inside the trace
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> float:
    """Wait for the work behind a tree of tensors (tuples, lists, dicts,
    named tuples); returns the sum of their absolute values as a float."""
    leaves = list(_tensors(tree))
    if not leaves:
        return 0.0
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return float(sum(float(t.detach().float().abs().sum()) for t in leaves))


@contextlib.contextmanager
def stage_timer(name: str, sink: Optional[dict] = None):
    """Wall-clock a stage; the caller fences the device work inside."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    log.info("%s: %.1f ms", name, dt * 1e3)
    if sink is not None:
        sink[name] = dt


def timed_fenced(name: str, fn, *args, reps: int = 1, sink: Optional[dict] = None):
    """Run fn(*args) once to warm, then ``reps`` times, fencing each; returns
    (result, best seconds)."""
    result = fn(*args)
    fence(result)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn(*args)
        fence(result)
        best = min(best, time.perf_counter() - t0)
    log.info("%s: %.1f ms (best of %d)", name, best * 1e3, reps)
    if sink is not None:
        sink[name] = best
    return result, best
