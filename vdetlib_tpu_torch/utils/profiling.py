"""Tracing — the port's copy of ``vdetlib_tpu/utils/profiling.py``.

:func:`device_trace` records a ``torch.profiler`` trace (host and, where a
card is present, CUDA activity) into a directory as a Chrome trace, which
Perfetto opens; the program's ``record_function`` spans (``runner.<part>``,
``fused.pipeline`` and ``fused.<stage>``, ``stream.<stage>``,
``track.<stage>``, and R-FCN's ``detect.backbone``, ``detect.score_maps``
and ``detect.psroi`` inside a detection step) name its ranges.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from vdetlib_tpu_torch.utils.log import get_logger

log = get_logger("profiling")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` into ``trace_dir/trace.json``.

    No-op when ``trace_dir`` is None, so callers can leave the hook in place.
    Records CUDA activity too where a card is present, and the spans of
    every thread (the sweep's ``runner.load`` runs on its prefetch thread)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
        if cuda:  # the block's device work ends inside the trace
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)
