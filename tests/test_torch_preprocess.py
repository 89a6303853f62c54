"""Port parity: the fused resize + normalize (kernel E's plain version).

The port's ``fused_resize_normalize`` against the JAX XLA function and the
JAX Pallas kernel in interpret mode, up- and downscale, with the detector's
mean and a non-unit scale: abs <= 1e-3 (values of O(100); the two packages'
float32 contractions may sum the two taps of a row in another order). The
taps the card's kernel reads (``resize_taps``) rebuild the same matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.kernels import preprocess as jpre
from vdetlib_tpu_torch.kernels import preprocess as tpre

MEAN = (102.98, 115.95, 122.77)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("src, dst", [((48, 64), (24, 32)), ((24, 32), (40, 56)),
                                      ((36, 48), (24, 32)), ((30, 40), (30, 40))],
                         ids=["down2", "up", "down1.5", "same"])
@pytest.mark.parametrize("scale", [1.0, 0.017])
def test_resize_normalize_matches_jax(src, dst, scale):
    frames = _frames(sum(src) + sum(dst), (3,) + src + (3,))
    want = np.asarray(jpre.fused_resize_normalize(jnp.asarray(frames), dst, MEAN, scale))
    got = tpre.fused_resize_normalize(torch.from_numpy(frames), dst, MEAN, scale).numpy()
    assert got.shape == want.shape == (3,) + dst + (3,)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dst", [(24, 32), (56, 72)], ids=["down", "up"])
def test_resize_normalize_matches_jax_pallas_interpret(dst):
    frames = _frames(7, (2, 40, 48, 3))
    want = np.asarray(jpre.fused_resize_normalize_pallas(jnp.asarray(frames), dst, MEAN,
                                                         interpret=True))
    got = tpre.fused_resize_normalize_kernel(torch.from_numpy(frames), dst, MEAN).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("src, dst", [(360, 240), (240, 176), (240, 304), (7, 7), (5, 11)])
def test_resize_taps_rebuild_the_matrix(src, dst):
    """Two taps per row, read from the float32 matrix: scattering them back
    gives the matrix exactly (the clamped edge's summed entry included)."""
    m = tpre._resize_matrix(src, dst)
    np.testing.assert_array_equal(m, jpre._resize_matrix(src, dst))
    lo, hi, w_lo, w_hi = tpre.resize_taps(src, dst)
    back = np.zeros_like(m)
    rows = np.arange(dst)
    np.add.at(back, (rows, lo), w_lo)
    np.add.at(back, (rows, hi), w_hi)
    np.testing.assert_array_equal(back, m)
    assert lo.dtype == hi.dtype == np.int32 and (hi - lo <= 1).all()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    frames = torch.from_numpy(_frames(3, (2, 20, 30, 3)))
    before = tpre.fused_resize_normalize_kernel.launches
    got = tpre.fused_resize_normalize_kernel(frames, (16, 24))
    assert tpre.fused_resize_normalize_kernel.launches == before
    assert torch.equal(got, tpre.fused_resize_normalize(frames, (16, 24)))
