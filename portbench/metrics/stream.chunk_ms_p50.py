"""The median latency of the window's full chunks (ms), untraced."""

import numpy as np


def read(ctx):
    ms = ctx["chunks_ms"]
    return float(np.median(ms)) if ms else None
