"""Port parity: per-frame per-class NMS over protos (the frame-NMS tool).

Mirrors tests/test_frame_nms.py. Tolerance: none — the port's ``host``,
``xla``, ``pallas`` and ``fixpoint`` backends (``xla`` takes the ``pallas``
route; on the CPU: the plain versions of kernels C and D; ``fixpoint`` the
Jacobi form) must return exactly the JAX ``host`` backend's det_proto, on a
sparse video (18 detections per frame: at 64 and 128 boxes the device route
runs kernel C's function) and a dense one (150 per frame: at 160 and 512
boxes, kernel D's). Scores sit on a
coarse grid, so exact ties occur; some detections carry two classes.
``nms_xla`` and ``nms_fixpoint`` equal the JAX functions' keep sets (and
visit order) exactly on random problems with ties, -0.0 scores and padded
slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.kernels import nms as jnms
from vdetlib_tpu.video.frame_nms import frame_nms as j_frame_nms
from vdetlib_tpu_torch.data.synth import (
    SynthConfig,
    det_proto_from_gt,
    make_video,
    vid_proto_in_memory,
)
from vdetlib_tpu_torch.kernels import nms as tnms
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.video import frame_nms as tframe_nms
from vdetlib_tpu_torch.video.frame_nms import frame_nms


def _protos(T, dets_per_object, distractors, seed):
    sv = make_video(SynthConfig(num_frames=T, seed=seed))
    det = det_proto_from_gt(sv, dets_per_object=dets_per_object,
                            distractors_per_frame=distractors)
    for i, d in enumerate(det["detections"]):
        s = d["scores"][0]
        s["score"] = round(s["score"] * 10) / 10  # exact ties
        if i % 5 == 0:  # a second class on some detections
            c = s["class_index"] % 3 + 1
            d["scores"].append({"class": str(c), "class_index": c, "score": 0.5})
    return vid_proto_in_memory(sv), det


@pytest.fixture(scope="module")
def sparse():
    vid, det = _protos(30, 4, 6, seed=0)
    return vid, det, j_frame_nms(vid, det, thresh=0.3, backend="host")


@pytest.fixture(scope="module")
def dense():
    vid, det = _protos(4, 40, 30, seed=1)
    return vid, det, j_frame_nms(vid, det, thresh=0.3, backend="host")


def _per_frame(det):
    counts = {}
    for d in det["detections"]:
        counts[d["frame"]] = counts.get(d["frame"], 0) + 1
    return counts


@pytest.mark.parametrize("backend, max_boxes", [
    ("host", None), ("xla", 64), ("pallas", 64), ("pallas", 128), ("fixpoint", 64),
    ("fixpoint", 128),
])
def test_sparse_backends_match_jax_host(sparse, backend, max_boxes):
    vid, det, want = sparse
    assert max(_per_frame(det).values()) <= 64 < len(det["detections"])
    kw = {} if max_boxes is None else dict(max_boxes=max_boxes, device="cpu")
    got = frame_nms(vid, det, thresh=0.3, backend=backend, **kw)
    assert len(want["detections"]) < len(det["detections"])
    assert got == want


@pytest.mark.parametrize("backend, max_boxes", [("xla", 160), ("pallas", 160), ("pallas", 512),
                                                ("fixpoint", 160), ("fixpoint", 512)])
def test_dense_backends_match_jax_host(dense, backend, max_boxes):
    vid, det, want = dense
    assert 128 < max(_per_frame(det).values()) <= 160
    got = frame_nms(vid, det, thresh=0.3, backend=backend, max_boxes=max_boxes, device="cpu")
    assert len(want["detections"]) < len(det["detections"])
    assert got == want


def test_unported_and_unknown_backends_raise(sparse):
    vid, det, _ = sparse
    with pytest.raises(ValueError):
        frame_nms(vid, det, backend="nope")


def test_fixpoint_backend_in_passes_matches_jax(dense, monkeypatch):
    """The fixpoint backend over several passes of a few problems each
    equals the JAX ``fixpoint`` backend and the ``host`` backend."""
    vid, det, want = dense
    monkeypatch.setattr(tframe_nms, "FIXPOINT_ELEMS", 3 * 160 * 160)
    got = frame_nms(vid, det, thresh=0.3, backend="fixpoint", max_boxes=160, device="cpu")
    assert got == want == j_frame_nms(vid, det, thresh=0.3, backend="fixpoint", max_boxes=160)


def _random_problems(B, N, seed):
    """Clustered boxes, scores on a coarse grid (ties) with -0.0 and +0.0
    among them, and padded slots (invalid, some with high scores)."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 100, (B, 4, 2))[:, rng.integers(0, 4, N)]
    wh = rng.uniform(8, 40, (B, N, 2))
    xy = ctr + rng.normal(0, 6, (B, N, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (np.round(rng.uniform(-0.2, 1, (B, N)) * 8) / 8).astype(np.float32)
    scores[rng.uniform(size=(B, N)) < 0.15] = -0.0
    valid = rng.uniform(size=(B, N)) < 0.8
    valid[:, -3:] = False
    return boxes, scores, valid


@pytest.mark.parametrize("N, thresh", [(1, 0.3), (17, 0.3), (64, 0.5), (200, 0.3), (200, 0.0)])
def test_nms_fixpoint_and_xla_match_jax(N, thresh):
    boxes, scores, valid = _random_problems(6, N, seed=N)
    assert (np.signbit(scores) & (scores == 0)).any() or N == 1
    want = np.asarray(jnms.nms_fixpoint(jnp.asarray(boxes), jnp.asarray(scores),
                                        jnp.asarray(valid), thresh))
    t = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    np.testing.assert_array_equal(tnms.nms_fixpoint(*t, thresh).numpy(), want)
    for b in range(len(boxes)):
        wk, wo = (np.asarray(x) for x in jnms.nms_xla(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(valid[b]), thresh))
        gk, go = (x.numpy() for x in tnms.nms_xla(t[0][b], t[1][b], t[2][b], thresh))
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gk, want[b])
    assert want.any() and (want.sum(-1) < valid.sum(-1)).any() or N == 1


def test_frame_nms_cli_matches_jax_host(sparse, tmp_path):
    from vdetlib_tpu_torch.cli import frame_nms as cli

    vid, det, want = sparse
    proto_dump(vid, str(tmp_path / "vid.json"))
    proto_dump(det, str(tmp_path / "det.json"))
    out = str(tmp_path / "out.json.gz")
    argv = [str(tmp_path / "vid.json"), str(tmp_path / "det.json"), out, "--thresh", "0.3",
            "--backend", "pallas", "--max_boxes", "64", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert proto_load(out) == want
    mtime = (tmp_path / "out.json.gz").stat().st_mtime_ns
    assert cli.main(argv) == 0  # resume-by-existence: not rewritten
    assert (tmp_path / "out.json.gz").stat().st_mtime_ns == mtime
