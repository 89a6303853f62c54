"""Shared by the training parity tests (tests/test_torch_train.py,
tests/test_torch_tracker_train.py)."""

import numpy as np


def assert_grads_close(got: dict, want: dict, rel: float = 1e-4):
    """Every gradient (name → tensor) within ``rel`` of its reference tensor's
    largest magnitude."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= rel * scale, (k, err, scale)
