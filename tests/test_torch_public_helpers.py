"""The public helpers the port's copies had left out, against the JAX
package on the same inputs: the protos accessors (JAX's
``tests/test_protos.py`` cases), ``elementwise_iou`` (``test_geometry.py``),
``batch_frames_from_array``, and the native host NMS (``csrc/nms_host.cpp``,
built with g++ at first use) against its numpy greedy and JAX's
``nms_host`` on random and tied inputs."""

import numpy as np
import pytest
import torch

from tests.conftest import random_boxes
from vdetlib_tpu import protos as jp
from vdetlib_tpu.data.loader import batch_frames_from_array as j_batch_frames
from vdetlib_tpu.data.synth import SynthConfig, box_proto, det_proto_from_gt, make_video
from vdetlib_tpu.data.synth import vid_proto_in_memory
from vdetlib_tpu.geometry import elementwise_iou as j_elementwise_iou
from vdetlib_tpu.geometry import pairwise_iou as j_pairwise_iou
from vdetlib_tpu.kernels.nms import nms_host as j_nms_host
from vdetlib_tpu_torch import protos as tp
from vdetlib_tpu_torch.data.loader import batch_frames_from_array
from vdetlib_tpu_torch.geometry import elementwise_iou, pairwise_iou
from vdetlib_tpu_torch.kernels import build
from vdetlib_tpu_torch.kernels.nms import nms_host, nms_host_plain


@pytest.fixture(scope="module")
def sv():
    return make_video(SynthConfig(num_frames=10, seed=3))


def test_frame_paths_match_jax(sv):
    vid = vid_proto_in_memory(sv)
    vid["root_path"] = "/data"
    for f in (0, 1, 5, 10, 11):
        for name in ("frame_path_before", "frame_path_after"):
            try:
                want = getattr(jp, name)(vid, f)
            except KeyError:
                with pytest.raises(KeyError):
                    getattr(tp, name)(vid, f)
            else:
                assert getattr(tp, name)(vid, f) == want, (name, f)
    assert tp.frame_path_before(vid, 5) == tp.frame_path_at(vid, 5)
    assert tp.frame_path_after(vid, 0) == tp.frame_path_at(vid, 1)


def test_det_accessors_match_jax(sv):
    dp = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=3)
    bp = box_proto(sv)
    for f in sv.frame_ids:
        assert tp.boxes_at_frame(bp, f) == jp.boxes_at_frame(bp, f)
        assert tp.dets_at_frame(dp, f) == jp.dets_at_frame(dp, f)
        assert tp.det_boxes_at_frame(dp, f) == jp.det_boxes_at_frame(dp, f)
        for c in range(5):
            assert tp.det_scores_at_frame(dp, f, c) == jp.det_scores_at_frame(dp, f, c)
    from vdetlib_tpu.protos.accessors import det_score as j_det_score

    for d in dp["detections"][:20]:
        for c in range(5):
            assert tp.det_score(d, c) == j_det_score(d, c)


def test_empty_det_and_top_detections_match_jax(sv):
    assert tp.empty_det_from_box([1, 2, 3, 4], 7) == jp.empty_det_from_box([1, 2, 3, 4], 7)
    assert tp.empty_det_from_box(np.float32([1.5, 2, 3, 4]), np.int64(7)) == \
        {"frame": 7, "bbox": [1.5, 2.0, 3.0, 4.0], "scores": []}
    dp = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=3)
    for k in (1, 5, 50):
        assert tp.top_detections(dp, k) == jp.top_detections(dp, k)
        for c in (1, 2):
            assert tp.top_detections(dp, k, class_index=c) == jp.top_detections(dp, k, c)
    top = tp.top_detections(dp, 5)
    scores = [max(s["score"] for s in d["scores"]) for d in top]
    assert scores == sorted(scores, reverse=True)


def test_track_accessors_match_jax(sv):
    fids = sv.frame_ids
    per_track = [
        [(f, [10 + f, 20, 50 + f, 60], 0.9) for f in fids[:5]],
        [(f, [100, 100 + f, 150, 150 + f], 0.8) for f in fids[2:8]],
    ]
    tr = tp.tracks_proto_from_boxes(per_track, "synth", anchors=[1, 3])
    assert tr == jp.tracks_proto_from_boxes(per_track, "synth", anchors=[1, 3])
    assert tp.track_box_at_frame(tr["tracks"][0], 3) == [13.0, 20.0, 53.0, 60.0]
    assert tp.track_box_at_frame(tr["tracks"][0], 9) is None
    for f in range(0, 12):
        assert tp.tracks_at_frame(tr, f) == jp.tracks_at_frame(tr, f)
        for t in tr["tracks"]:
            assert tp.track_box_at_frame(t, f) == jp.track_box_at_frame(t, f)
    assert len(tp.tracks_at_frame(tr, 3)) == 2 and len(tp.tracks_at_frame(tr, 1)) == 1


def test_elementwise_iou_matches_jax(rng):
    a = random_boxes(rng, 24)
    b = random_boxes(rng, 24)
    b[:4] = a[:4]  # identical boxes: IoU 1
    b[4, 0] = a[4, 2] + 5.0  # disjoint along x: IoU 0
    b[4, 2] = b[4, 0] + 10.0
    got = elementwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_elementwise_iou(a, b)), rtol=1e-6, atol=1e-7)
    full = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(np.diag(full), got, rtol=1e-6)
    assert got[4] == 0.0 and np.allclose(got[:4], 1.0)
    np.testing.assert_allclose(np.diag(np.asarray(j_pairwise_iou(a, b))), got, rtol=1e-6)
    shaped = elementwise_iou(torch.from_numpy(a[:6].reshape(2, 3, 4)),
                             torch.from_numpy(b[:6].reshape(2, 3, 4)))
    assert shaped.shape == (2, 3)


@pytest.mark.parametrize("T, batch", [(10, 4), (8, 4), (3, 8), (1, 1)])
def test_batch_frames_from_array_matches_jax(T, batch):
    frames = np.random.default_rng(T).integers(0, 255, (T, 6, 8, 3), dtype=np.uint8)
    got = list(batch_frames_from_array(frames, batch))
    want = list(j_batch_frames(frames, batch))
    assert len(got) == len(want) == -(-T // batch)
    for (gi, gb), (wi, wb) in zip(got, want):
        assert gi == wi and gb.shape == (batch, 6, 8, 3)
        np.testing.assert_array_equal(gb, wb)


def _dets(rng, n, tied):
    boxes = random_boxes(rng, n, width=200.0, height=150.0)
    scores = (rng.integers(0, 4, n) / 4.0 if tied else rng.random(n)).astype(np.float32)
    if tied and n > 3:
        boxes[1] = boxes[0]  # exact duplicate box with an equal score
        scores[1] = scores[0]
    return np.concatenate([boxes, scores[:, None]], axis=1).astype(np.float32)


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("n", [0, 1, 7, 64, 512])
def test_native_nms_matches_numpy_and_jax(n, tied):
    rng = np.random.default_rng(n + 7 * tied)
    dets = _dets(rng, n, tied)
    for thresh in (0.3, 0.5, 0.7):
        got = nms_host(dets, thresh)
        assert got == nms_host_plain(dets, thresh), thresh
        assert got == j_nms_host(dets, thresh), thresh
        assert all(isinstance(i, int) for i in got)


def test_native_nms_is_built_from_the_ports_source():
    """nms_host runs the library of csrc/nms_host.cpp in _build/ (no numpy
    fallback: the name resolves to the loaded C function)."""
    so = build.library_path("nms_host")
    assert so.parent == build.BUILD_DIR and so.name.startswith("libnms_host-")
    assert build.load("nms_host").__name__ == "vdet_nms"
    assert so.is_file()


def test_native_nms_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises KernelError: nothing falls back to numpy."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    build._load.cache_clear()
    try:
        with pytest.raises(build.KernelError, match="no compiler here"):
            nms_host(_dets(np.random.default_rng(0), 8, False), 0.3)
    finally:
        build._load.cache_clear()
