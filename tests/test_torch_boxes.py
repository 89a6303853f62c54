"""Port parity: box geometry (vdetlib_tpu_torch.geometry.boxes vs the JAX module).

Tolerance 1e-6 (absolute, px / IoU): the same float32 ops in the same order;
only exp() may differ in the last bit between the two libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.geometry import boxes as jb
from vdetlib_tpu_torch.geometry import boxes as tb

torch.set_num_threads(2)

TOL = 1e-6


def _boxes(rng, n):
    x1 = rng.uniform(0, 300, n)
    y1 = rng.uniform(0, 220, n)
    w = rng.uniform(-5, 120, n)  # some degenerate / inverted boxes
    h = rng.uniform(-5, 120, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_pairwise_iou(offset):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[5] = b[7]  # an exact duplicate: IoU 1
    want = np.asarray(jb.pairwise_iou(jnp.asarray(a), jnp.asarray(b), offset=offset))
    got = tb.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), offset=offset).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # batched leading axes
    a3, b3 = a.reshape(4, 10, 4), b[:20].reshape(4, 5, 4)
    want3 = np.asarray(jb.pairwise_iou(jnp.asarray(a3), jnp.asarray(b3)))
    got3 = tb.pairwise_iou(torch.from_numpy(a3), torch.from_numpy(b3)).numpy()
    np.testing.assert_allclose(got3, want3, atol=TOL, rtol=0)


def test_apply_deltas_and_clamp_edge():
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 64)
    deltas = rng.normal(0, 0.5, (64, 4)).astype(np.float32)
    # dw/dh at, just inside and far beyond the _DELTA_CLAMP edge, both signs
    c = np.float32(jb._DELTA_CLAMP)
    deltas[:6, 2] = [c, -c, c * 0.999, 10.0, -10.0, 50.0]
    deltas[:6, 3] = [-c, c, -c * 0.999, -10.0, 10.0, -50.0]
    want = np.asarray(jb.apply_deltas(jnp.asarray(boxes), jnp.asarray(deltas)))
    got = tb.apply_deltas(torch.from_numpy(boxes), torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)
    assert tb._DELTA_CLAMP == jb._DELTA_CLAMP


def test_clip_and_shift():
    rng = np.random.default_rng(2)
    boxes = (_boxes(rng, 50) * 1.5 - 40).astype(np.float32)
    want = np.asarray(jb.clip_boxes(jnp.asarray(boxes), 240, 320))
    got = tb.clip_boxes(torch.from_numpy(boxes), 240, 320).numpy()
    np.testing.assert_array_equal(got, want)
    shift = rng.normal(0, 3, (50, 2)).astype(np.float32)
    want = np.asarray(jb.shift_boxes(jnp.asarray(boxes), jnp.asarray(shift)))
    got = tb.shift_boxes(torch.from_numpy(boxes), torch.from_numpy(shift)).numpy()
    np.testing.assert_array_equal(got, want)
