"""Port parity: grouped greedy NMS (the plain version of the CUDA kernel B).

Tolerance: none. Keep sets are threshold decisions and must equal the JAX
``nms_grouped`` exactly, including score ties (broken by index), invalid
slots (never suppress, never kept) and padded slots (group -1, valid 0),
and equal per-group greedy NMS by the numpy oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_boxes
from tests.oracle.nms import nms as oracle_nms
from vdetlib_tpu.kernels.nms import nms_grouped as j_nms_grouped
from vdetlib_tpu_torch.kernels import nms_grouped as kb
from vdetlib_tpu_torch.kernels.nms import nms_grouped

torch.set_num_threads(2)


def _problem(seed, T, N, groups=6, pad=0):
    """Clustered boxes (many overlaps), forced ties, invalid and padded slots."""
    rng = np.random.default_rng(seed)
    centers = random_boxes(rng, 5)
    boxes = np.zeros((T, N, 4), np.float32)
    for t in range(T):
        base = centers[rng.integers(0, 5, N)]
        boxes[t] = base + rng.normal(0, 6.0, (N, 4)).astype(np.float32)
    # scores on a coarse grid: many exact ties
    scores = (rng.integers(0, 12, (T, N)) / 12.0).astype(np.float32)
    # duplicates: identical box and score in the same group
    boxes[:, 1] = boxes[:, 0]
    scores[:, 1] = scores[:, 0]
    grp = rng.integers(1, groups + 1, (T, N)).astype(np.int32)
    grp[:, 1] = grp[:, 0]
    valid = rng.uniform(size=(T, N)) > 0.2
    if pad:
        valid[:, N - pad:] = False
        grp[:, N - pad:] = -1
        scores[:, N - pad:] = 0.0
    return boxes, scores, valid, grp


def _oracle(boxes, scores, valid, grp, thresh):
    keep = np.zeros(valid.shape, bool)
    for t in range(valid.shape[0]):
        for g in np.unique(grp[t][valid[t]]):
            idx = np.nonzero(valid[t] & (grp[t] == g))[0]
            dets = np.concatenate([boxes[t, idx], scores[t, idx, None]], 1)
            keep[t, idx[oracle_nms(dets, thresh)]] = True
    return keep


@pytest.mark.parametrize("N, pad", [(48, 0), (48, 5), (192, 0), (192, 17)])
def test_nms_grouped_matches_jax_exactly(N, pad):
    boxes, scores, valid, grp = _problem(N + pad, 4, N, pad=pad)
    thresh = 0.3
    want = np.asarray(j_nms_grouped(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), jnp.asarray(grp), thresh
    ))
    got = nms_grouped(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
        torch.from_numpy(grp), thresh,
    ).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(boxes, scores, valid, grp, thresh))
    # the fixture really holds ties and suppressions
    assert (scores[:, 0] == scores[:, 1]).all() and (want.sum() < valid.sum())


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    boxes, scores, valid, grp = _problem(7, 2, 32)
    before = kb.nms_grouped_kernel.launches
    keep = kb.nms_grouped_kernel(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
        torch.from_numpy(grp), 0.5,
    )
    assert kb.nms_grouped_kernel.launches == before
    want = kb.nms_unsorted_fixpoint(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.5,
        groups=torch.from_numpy(grp),
    )
    assert torch.equal(keep, want)


def test_wrapper_rejects_meta_tensors():
    """A tensor on neither the CPU nor a CUDA device raises, never falls back."""
    b = torch.zeros((1, 4, 4), device="meta")
    s = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError):
        kb.nms_grouped_kernel(b, s, s.bool(), s.int(), 0.5)
