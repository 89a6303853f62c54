"""Port parity: tubelet rescoring and seq-NMS linking.

Tolerances: rescored scores and tubelet statistics to 1e-5 (the same float32
sums, taken in another order); seq-NMS path ids exactly (threshold and
argmax decisions) and scores to 1e-5; both also against the numpy oracles in
tests/oracle/. argmax ties must resolve to the FIRST maximum, as
``jnp.argmax`` does — the seq-NMS path start and backpointers depend on it.
What the card's route does in torch before kernel G launches (the packed
IoU tests) is checked here against the dense tests; the kernel itself in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_boxes
from tests.oracle.rescore import rescore as oracle_rescore
from tests.oracle.seq_nms import seq_nms as oracle_seq_nms
from vdetlib_tpu.kernels.seq_nms import seq_nms_batch as j_seq_nms_batch
from vdetlib_tpu.video.rescore import rescore_arrays as j_rescore
from vdetlib_tpu_torch.geometry.boxes import pairwise_iou
from vdetlib_tpu_torch.kernels import seq_nms as ksn
from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_batch, seq_nms_single
from vdetlib_tpu_torch.video.rescore import rescore_arrays

torch.set_num_threads(2)


def _tracky(rng, T, N):
    """Boxes drifting smoothly so that frame-to-frame links exist."""
    base = random_boxes(rng, N)
    boxes = np.zeros((T, N, 4), np.float32)
    for t in range(T):
        boxes[t] = base + rng.normal(0, 2.0, (N, 1)) * np.array([1, 0.5, 1, 0.5], np.float32)
    return boxes


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("boost, min_frac, floor", [("max", 0.0, 0), ("mean", 0.4, 3)])
def test_rescore_matches_jax_and_oracle(boost, min_frac, floor):
    rng = np.random.default_rng(5)
    T, N, C, K = 7, 10, 4, 5
    det_boxes = _tracky(rng, T, N)
    det_scores = rng.uniform(0, 1, (T, N, C)).astype(np.float32)
    det_mask = rng.uniform(size=(T, N)) > 0.25
    det_scores *= det_mask[..., None]
    trk_boxes = det_boxes[:, rng.integers(0, N, K)].transpose(1, 0, 2) + rng.normal(
        0, 3, (K, T, 4)).astype(np.float32)
    trk_mask = rng.uniform(size=(K, T)) > 0.3
    args = (det_boxes, det_scores, det_mask, trk_boxes, trk_mask)
    kw = dict(top_ratio=0.5, boost=boost, min_matched_frac=min_frac, stat_floor=float(floor))
    jn, js, jm = j_rescore(*(jnp.asarray(a) for a in args), 0.5, 0.8, **kw)
    tn, ts, tm = rescore_arrays(*(_t(a) for a in args), 0.5, 0.8, **kw)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want, _ = oracle_rescore(*args, match_thresh=0.5, bg_decay=0.8, top_ratio=0.5, boost=boost,
                             min_matched_frac=min_frac, stat_floor=floor)
    np.testing.assert_allclose(tn.numpy(), want, atol=1e-5, rtol=0)
    assert tm.numpy().any() and not tm.numpy().all()  # some tracks match, some frames not


def _seq_problem(seed, T=8, N=12, C=3, ties=False):
    rng = np.random.default_rng(seed)
    boxes = _tracky(rng, T, N)
    scores = rng.uniform(0.05, 1, (C, T, N)).astype(np.float32)
    if ties:  # duplicate boxes with equal scores: argmax ties everywhere
        boxes[:, 1] = boxes[:, 0]
        scores = np.round(scores * 4) / 4
        scores[:, :, 1] = scores[:, :, 0]
    mask = rng.uniform(size=(C, T, N)) > 0.2
    return boxes, scores, mask


@pytest.mark.parametrize("seed, ties, rescore", [(0, False, "avg"), (1, True, "avg"),
                                                   (2, True, "max")])
def test_seq_nms_batch_matches_jax(seed, ties, rescore):
    boxes, scores, mask = _seq_problem(seed, ties=ties)
    jo, jp = j_seq_nms_batch(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask),
                             0.5, 0.3, max_paths=20, rescore=rescore)
    to, tp = seq_nms_batch(_t(boxes), _t(scores), _t(mask), 0.5, 0.3, max_paths=20,
                           rescore=rescore)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert tp.numpy().max() >= 2  # several paths per class were extracted


@pytest.mark.parametrize("seed", [3, 4])
def test_seq_nms_single_matches_oracle(seed):
    boxes, scores, mask = _seq_problem(seed, C=1)
    s, m = scores[0], mask[0]
    out, pid = seq_nms_single(_t(boxes), _t(s), _t(m), 0.5, 0.3, max_paths=50)
    T = m.shape[0]
    want, paths = oracle_seq_nms([boxes[t][m[t]] for t in range(T)],
                                 [s[t][m[t]] for t in range(T)], 0.5, 0.3, max_paths=50)
    for t in range(T):
        np.testing.assert_allclose(out.numpy()[t][m[t]], want[t], atol=1e-5, rtol=0)
    assert int(pid.max()) + 1 == len(paths)
    # each oracle path carries one id on exactly its boxes
    for k, (_, path) in enumerate(paths):
        on = {(t, int(np.nonzero(m[t])[0][i])) for t, i in path}
        assert on == {tuple(x) for x in np.argwhere(pid.numpy() == k)}


def test_seq_nms_max_paths_budget_and_empty():
    boxes, scores, mask = _seq_problem(6)
    _, jp = j_seq_nms_batch(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask),
                            0.5, 0.3, max_paths=2)
    _, tp = seq_nms_batch(_t(boxes), _t(scores), _t(mask), 0.5, 0.3, max_paths=2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp.numpy().max() == 1
    out, pid = seq_nms_batch(_t(boxes), _t(scores), _t(np.zeros_like(mask)), 0.5, 0.3,
                             max_paths=4)
    assert (pid.numpy() == -1).all() and (out.numpy() == 0).all()


def test_torch_argmax_returns_first_maximum():
    """The tie rule the pick order and the backpointers rely on."""
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1], [0.2, 0.2, 0.2, 0.2]])
    assert torch.argmax(x, dim=1).tolist() == [1, 0]
    assert int(torch.argmax(torch.tensor([3.0, 7.0, 7.0, 7.0]))) == 1
    assert np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=1)).tolist() == [1, 0]


def _unpack(words, n):
    """int64 bit words (..., K) → (..., K, n) bool, bit i at [..., i]."""
    return ((words[..., None] >> torch.arange(n)) & 1).bool()


def _on_threshold_boxes():
    """Frames whose pairs sit exactly on the thresholds 0.5 and 0.25 (legacy
    offset: [0, 0, 9, 9] has area 100), beside pairs just above them."""
    frame = np.array([[0, 0, 9, 9], [0, 0, 9, 4], [0, 0, 4, 4], [0, 0, 9, 5], [0, 0, 5, 4]],
                     np.float32)
    return np.stack([frame, frame[[1, 0, 3, 2, 4]], frame])


@pytest.mark.parametrize("case", ["link", "over", "link_offset0", "over_offset0",
                                  "on_threshold", "cpu_route"])
def test_seq_nms_kernel_inputs_on_the_cpu(case):
    """Kernel G's packed IoU tests (``link_masks``) equal the plain
    version's dense ``pairwise_iou(...) > thresh``, at 64 slots (bit 63
    included), at both offsets and exactly on the thresholds; CPU tensors
    take the plain version, no launch and no count."""
    if case == "cpu_route":
        boxes, scores, mask = (_t(a) for a in _seq_problem(7, T=9, N=20))
        launches, plain_calls = ksn.seq_nms_kernel.launches, seq_nms_batch.plain_calls
        got = seq_nms_batch(boxes, scores, mask, 0.5, 0.3, max_paths=12, rescore="max")
        want = ksn.seq_nms_plain(boxes, scores, mask, 0.5, 0.3, max_paths=12, rescore="max")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[1].max()) >= 2
        assert (ksn.seq_nms_kernel.launches, seq_nms_batch.plain_calls) == (launches, plain_calls)
        return
    offset = 0.0 if case.endswith("offset0") else 1.0
    link_thresh, suppress_thresh = (0.5, 0.25) if case == "on_threshold" else (0.5, 0.3)
    if case == "on_threshold":
        boxes = torch.from_numpy(_on_threshold_boxes())
    else:
        boxes = torch.from_numpy(_tracky(np.random.default_rng(11), 6, 64))
    link, over = ksn.link_masks(boxes, link_thresh, suppress_thresh, offset)
    T, N = boxes.shape[:2]
    assert link.shape == (T - 1, N) and over.shape == (T, N) and link.dtype == torch.int64
    want_link = pairwise_iou(boxes[:-1], boxes[1:], offset=offset) > link_thresh  # [t, i, j]
    want_over = pairwise_iou(boxes, boxes, offset=offset) > suppress_thresh  # [t, p, j]
    assert torch.equal(_unpack(link, N).transpose(1, 2), want_link)
    assert torch.equal(_unpack(over, N), want_over)
    if case == "on_threshold":
        iou = pairwise_iou(boxes, boxes)
        assert float(iou[0, 0, 1]) == 0.5 and float(iou[0, 0, 2]) == 0.25
        assert not want_over[0, 0, 2] and want_over[0, 0, 1] and not want_link[0, 0, 0]
    else:
        assert 0 < int(want_link.sum()) < want_link.numel()
        assert int(want_link[:, 63].sum()) > 0
        assert int(want_over[:, :, 63].sum()) > T  # slot 63 overlaps more than itself
