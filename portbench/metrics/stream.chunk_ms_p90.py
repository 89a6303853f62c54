"""The 90th percentile of the window's full-chunk latencies (ms), untraced."""

import numpy as np


def read(ctx):
    ms = ctx["chunks_ms"]
    return float(np.percentile(ms, 90)) if ms else None
