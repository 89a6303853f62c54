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
from vdetlib_tpu_torch.geometry.boxes import pairwise_iou
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


@pytest.mark.parametrize("B, N, want", [(256, 192, 512), (32, 192, 672), (960, 192, 192),
                                        (1, 1, 32), (3, 33, 96), (1, 512, 1024), (5000, 512, 512),
                                        (960, 64, 96), (5, 7, 32), (960, 128, 128)])
def test_launch_threads(B, N, want):
    """The block of kernels B and C: at least a thread a slot, rounded to
    warps; more where few problems share the card's 132 SMs, but never more
    than a warp for each adjacency tile (32 × 32, on and above the
    diagonal) or 1024."""
    got = kb.launch_threads(B, N, sms=132)
    assert got == want
    assert got % 32 == 0 and N <= got <= kb.MAX_THREADS


def test_smem_bytes_fit_a_block():
    """The shared memory of a block at 192 slots stays under the default
    48 KB; at the 512-slot limit it needs the opt-in but fits the H100."""
    assert kb.smem_bytes(192) == 192 * 40 + 192 * 6 * 4 + 192 <= 48 * 1024
    assert 48 * 1024 < kb.smem_bytes(kb.MAX_SLOTS) <= 232448


def _pair_boxes(seed, n):
    """Pairs of every kind: clustered overlaps, far apart (no intersection),
    touching edges (an intersection of exactly 0 with the +1 offset) and
    identical boxes."""
    rng = np.random.default_rng(seed)
    a = random_boxes(rng, n).astype(np.float32)
    b = a + rng.normal(0, 8, a.shape).astype(np.float32)
    b[::4] = a[::4] + np.float32(300)  # far apart
    w = a[1::4, 2] - a[1::4, 0]
    b[1::4] = a[1::4] + np.stack([w + 1, 0 * w, w + 1, 0 * w], 1)  # touching at x2 + 1
    b[2::8] = a[2::8]  # identical
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7, 0.0, -0.0, -0.1, -1.0, 1e-30, 2.0**61])
def test_iou_exceeds_equals_the_divided_decision(thresh):
    """The kernels' decision (no division where the intersection is 0 or
    the filter is sure) equals ``pairwise_iou > thresh`` on every pair, at
    thresholds of 0 and below (where a zero intersection suppresses iff
    thresh < 0) and outside the filter's range (every pair divides)."""
    a, b = _pair_boxes(11, 64)
    got = kb.iou_exceeds(a, b, thresh)
    iou = pairwise_iou(a, b)
    assert torch.equal(got, iou > thresh)
    zero = iou == 0
    assert zero.any() and (~zero).any()
    assert bool((got[zero] == (thresh < 0)).all())


def test_iou_exceeds_at_the_threshold():
    """[0, 0, 9, 9] and [0, 0, 9, 19] with the +1 offset: IoU 100/200 = 0.5
    exactly. At 0.5 the pair does not exceed; one float below 0.5 it does."""
    a = torch.tensor([[0.0, 0.0, 9.0, 9.0]])
    b = torch.tensor([[0.0, 0.0, 9.0, 19.0]])
    assert float(pairwise_iou(a, b)) == 0.5
    assert not bool(kb.iou_exceeds(a, b, 0.5))
    below = float(np.nextafter(np.float32(0.5), np.float32(0)))
    assert bool(kb.iou_exceeds(a, b, below)) and bool(pairwise_iou(a, b) > below)


def test_iou_exceeds_in_the_band_around_each_pairs_iou():
    """Every pair at thresholds of its own IoU and of the floats one and
    two steps either side: the band where the filter is not sure and the
    kernels divide, and just outside it."""
    a, b = _pair_boxes(12, 24)
    iou = pairwise_iou(a, b)
    for v in iou[iou > 0][:120].tolist():
        f = np.float32(v)
        down, up = np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(2))
        for t in (f, down, np.nextafter(down, np.float32(0)), up, np.nextafter(up, np.float32(2)),
                  f * np.float32(1 + 2**-20), f * np.float32(1 - 2**-20)):
            assert torch.equal(kb.iou_exceeds(a, b, float(t)), iou > float(t)), (v, t)
