"""Kernel D's launch plan, its visit key, and the budgets above 512 slots, on the CPU.

- ``launch_threads(N)`` and ``smem_bytes(N)`` (the wrapper's launch plan,
  mirroring ``csrc/nms_sorted.cu``): D's limit is at least 4,096 slots and
  its block fits the H100's 232,448 bytes of opt-in shared memory; one slot
  more is refused by the check the wrapper runs.
- ``visit_key`` (the model of ``nms_sorted.cu::vdet_visit_key``) orders the
  valid slots exactly as ``visit_order`` (torch.sort of -masked score,
  stable) does, through ties, ±0.0, NaN and ±inf.
- Above 512 slots, where the kernel's old limit stood, the port equals the
  JAX package with no tolerance (keep sets are threshold decisions):
  ``nms_sorted_greedy`` at N = 640 against JAX ``nms_pallas_batch(...,
  interpret=True)`` and at N = 1024 against JAX ``batched_nms`` (its XLA
  fixpoint, the same keep set); the port's ``batched_nms`` at N = 600 and
  1024 against JAX ``batched_nms``; and ``frame_nms(..., backend="pallas",
  max_boxes=1024, device="cpu")`` against the JAX ``host`` backend on frames
  of more than 512 detections.

The kernel itself runs only on a card: tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_nms_batched import _check, _problem, _t
from vdetlib_tpu.kernels.nms import batched_nms as j_batched_nms
from vdetlib_tpu.kernels.nms_pallas import nms_pallas_batch
from vdetlib_tpu.video.frame_nms import frame_nms as j_frame_nms
from vdetlib_tpu_torch.data.synth import (
    SynthConfig,
    det_proto_from_gt,
    make_video,
    vid_proto_in_memory,
)
from vdetlib_tpu_torch.kernels import nms_sorted as kd
from vdetlib_tpu_torch.kernels.nms import batched_nms
from vdetlib_tpu_torch.kernels.nms_grouped import check_slots
from vdetlib_tpu_torch.video.frame_nms import frame_nms, pack_frame_problems

torch.set_num_threads(2)

THRESH = 0.3
H100_SMEM_OPTIN = 232_448


def test_limit_fits_the_h100_and_one_more_slot_is_refused():
    assert kd.MAX_SLOTS >= 4096
    assert kd.smem_bytes(kd.MAX_SLOTS) <= H100_SMEM_OPTIN < kd.smem_bytes(kd.MAX_SLOTS + 1)
    check_slots("nms_sorted", kd.MAX_SLOTS, 1920, kd.MAX_SLOTS)
    with pytest.raises(ValueError, match=f"N <= {kd.MAX_SLOTS}"):
        check_slots("nms_sorted", kd.MAX_SLOTS, 1, kd.MAX_SLOTS + 1)


@pytest.mark.parametrize("N, want", [(1, 32), (32, 32), (33, 32), (100, 32), (200, 64),
                                     (512, 128), (513, 256), (2048, 512), (4096, 1024),
                                     (8192, 1024)])
def test_launch_threads(N, want):
    """A quarter of N rounded up to a power of two, a warp at least, 1024 at
    most; always a multiple of 32."""
    assert kd.launch_threads(N) == want


@pytest.mark.parametrize("N", [1, 31, 32, 33, 512, 513, 4096, 8192])
def test_smem_bytes_mirrors_the_layout(N):
    """Keys for N rounded up to a power of two (>= 32), 20 bytes a slot, a bit
    a slot and 66 words; 48 KB and more take the opt-in (from 1,920 slots)."""
    p = max(32, 1 << (N - 1).bit_length())
    assert kd.smem_bytes(N) == 8 * p + 20 * N + 4 * ((N + 31) // 32) + 264
    assert (kd.smem_bytes(N) > 48 * 1024) == (N > 1800)


def _valid_in_key_order(scores, valid):
    """Each problem's valid slots sorted by ``visit_key`` ascending."""
    out = []
    for s, v in zip(scores, valid):
        idx = np.nonzero(v)[0]
        out.append(idx[np.argsort(kd.visit_key(s[idx], idx), kind="stable")].tolist())
    return out


def _valid_in_visit_order(scores, valid):
    order = kd.visit_order(torch.from_numpy(scores), torch.from_numpy(valid)).numpy()
    return [[int(i) for i in o if v[i]] for o, v in zip(order, valid)]


SPECIAL = np.array([0.5, 0.25, 0.0, -0.0, np.nan, np.inf, -np.inf, -1.0], np.float32)


@pytest.mark.parametrize("case", ["ties", "signed_zero", "nan", "inf", "mixed", "one_valid",
                                  "none_valid"])
def test_visit_key_sorts_valid_slots_as_visit_order(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    n = 64
    pool = {"ties": SPECIAL[:2], "signed_zero": SPECIAL[2:4], "nan": SPECIAL[[0, 4]],
            "inf": SPECIAL[[0, 5, 6, 7]]}.get(case, SPECIAL)
    scores = pool[rng.integers(0, len(pool), (4, n))]
    valid = rng.uniform(size=(4, n)) > 0.3
    if case == "one_valid":
        valid[:] = False
        valid[np.arange(4), rng.integers(0, n, 4)] = True
    if case == "none_valid":
        valid[:] = False
    got = _valid_in_key_order(scores, valid)
    assert got == _valid_in_visit_order(scores, valid)
    assert [len(g) for g in got] == valid.sum(1).tolist()
    if case == "nan":  # NaN scores come last, by index
        for g, s in zip(got, scores):
            nans = [i for i in g if np.isnan(s[i])]
            assert g[len(g) - len(nans):] == sorted(nans)


def test_visit_key_bits():
    """+inf first, -0.0 ties +0.0 (by index), -inf after -1, NaN after -inf."""
    s = np.array([np.inf, 0.0, -0.0, -1.0, -np.inf, np.nan, np.nan], np.float32)
    k = kd.visit_key(s, np.arange(7))
    assert [int(x) for x in k] == sorted(int(x) for x in k)  # already in key order
    assert len(set(k.tolist())) == 7
    assert k[1] >> np.uint64(32) == k[2] >> np.uint64(32)
    assert k[5] >> np.uint64(32) == np.uint64(0xFFFFFFFF)


def test_nms_sorted_greedy_matches_pallas_batch_at_640():
    boxes, scores, valid = _problem(640, B=2, seed=1)
    want = np.asarray(nms_pallas_batch(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), THRESH, interpret=True))
    got = kd.nms_sorted_greedy(*_t(boxes, scores, valid), THRESH).numpy()
    _check(got, want, boxes, scores, valid)


def test_nms_sorted_greedy_matches_jax_batched_nms_at_1024():
    boxes, scores, valid = _problem(1024, seed=3)
    want = np.asarray(j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), THRESH))
    got = kd.nms_sorted_greedy(*_t(boxes, scores, valid), THRESH).numpy()
    _check(got, want, boxes, scores, valid)


@pytest.mark.parametrize("N", [600, 1024])
def test_batched_nms_matches_jax_above_512(N):
    boxes, scores, valid = _problem(N, seed=5)
    want = np.asarray(j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), THRESH))
    got = batched_nms(*_t(boxes, scores, valid), THRESH).numpy()
    _check(got, want, boxes, scores, valid)


@pytest.fixture(scope="module")
def crowded():
    """Two frames of 3 objects of one class × 200 jittered detections and 200
    distractors (800 a frame), scores on a coarse grid, every 5th with a
    second class."""
    sv = make_video(SynthConfig(num_frames=2, num_classes=2, seed=3))
    det = det_proto_from_gt(sv, dets_per_object=200, distractors_per_frame=200)
    for i, d in enumerate(det["detections"]):
        s = d["scores"][0]
        s["score"] = round(s["score"] * 10) / 10
        if i % 5 == 0:
            c = s["class_index"] % 3 + 1
            d["scores"].append({"class": str(c), "class_index": c, "score": 0.5})
    vid = vid_proto_in_memory(sv)
    return vid, det, j_frame_nms(vid, det, thresh=THRESH, backend="host")


def test_smoke_runs_problems_are_the_frame_nms_tools():
    """``chip_smoke.py`` times kernel D on the frame-NMS tool's own problems,
    packed from the protos alone (so that an earlier tree can be timed on
    them): they equal what ``pack_frame_problems`` hands the kernel."""
    from chip_smoke import frame_nms_problems, frame_nms_protos

    boxes, scores, valid, _, _ = pack_frame_problems(*frame_nms_protos(3, 512, seed=512), 512)
    T, C, N = scores.shape
    got = frame_nms_problems(3, 512, seed=512)
    np.testing.assert_array_equal(got[0], np.broadcast_to(boxes[:, None], (T, C, N, 4))
                                  .reshape(T * C, N, 4))
    np.testing.assert_array_equal(got[1], scores.reshape(T * C, N))
    np.testing.assert_array_equal(got[2], valid.reshape(T * C, N))
    assert 0 < valid.sum(-1).mean() < 32  # sparse: ~17 valid slots of 512


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_frame_nms_at_1024_boxes_matches_jax_host(crowded, backend):
    vid, det, want = crowded
    _, _, has_entry, det_index, _ = pack_frame_problems(vid, det, 1024)
    assert (det_index >= 0).sum(1).min() > 512  # every frame beyond the old limit
    assert has_entry.sum(-1).max() > 512  # and a class problem too
    got = frame_nms(vid, det, thresh=THRESH, backend=backend, max_boxes=1024, device="cpu")
    assert 0 < len(want["detections"]) < len(det["detections"])
    assert got == want
