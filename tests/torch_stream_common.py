"""Shared fixtures and comparisons of the stream parity tests
(tests/test_torch_stream.py, tests/test_torch_stream_stride.py).

The tiny preset (96×128, R=16, C=4, 6 track slots, chunk 8) with the JAX
detector and tracker in float32 and the same weights converted to the port
(at bf16 the two frameworks round at other places; see
tests/test_torch_fused.py): the nets of tests/torch_fused_common.py. The bounds are the cross-compilation bound of
``__graft_entry__.py:271-291``: keep bits exact, boxes within 0.5 px,
scores within 0.01, path ids differing on < 1% of slots; track segments on
the same frames.
"""

import numpy as np
import pytest
import torch

from tests.torch_fused_common import HW, C, R, f32_nets
from vdetlib_tpu.data.synth import SynthConfig, box_proto, make_video, write_frames
from vdetlib_tpu_torch.protos import proto_dump, proto_load

A, CH = 6, 8
TOL_BOX, TOL_SCORE = 0.5, 0.01


def _opts(mod, **kw):
    return mod.StreamOptions(**{**dict(chunk=CH, max_rois=R, num_classes=C, track_slots=A,
                                       seed_thresh=0.2, conf_thresh=0.3, max_paths=20), **kw})


@pytest.fixture(scope="module")
def nets():
    n = f32_nets()
    return dict(jdet=n.jdet, jdp=n.jdp, jtrk=n.jtrk, jtp=n.jtp, jcfg=n.jtrk_cfg,
                tdet=n.tdet, ttrk=n.ttrk, tcfg=n.ttrk_cfg)


def _inputs(n_frames, seed):
    """Jittered ground truth plus random clutter; a varying count of real
    proposals per frame (the rest are zero boxes)."""
    sv = make_video(SynthConfig(num_frames=n_frames, height=HW[0], width=HW[1], num_classes=C,
                                seed=seed, max_speed=2.0))
    rng = np.random.default_rng(seed)
    rois = np.zeros((n_frames, R, 4), np.float32)
    K = sv.gt_boxes.shape[0]
    for t in range(n_frames):
        n_real = R - int(rng.integers(0, 5))
        k = rng.integers(0, K, n_real)
        b = sv.gt_boxes[k, t] + rng.normal(0, 3, (n_real, 4))
        b[::4, :2] = rng.uniform(0, 80, (len(b[::4]), 2))  # clutter
        b[::4, 2:] = b[::4, :2] + rng.uniform(10, 40, (len(b[::4]), 2))
        rois[t, :n_real] = np.clip(b, 0, [HW[1] - 1, HW[0] - 1] * 2)
    return sv, rois


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_boxes(got, want, mask=None):
    g, w = np.asarray(got), np.asarray(want)
    if mask is not None:
        g, w = g[mask], w[mask]
    np.testing.assert_allclose(g, w, atol=TOL_BOX, rtol=0)


def _chunks(frames):
    return (frames[s:s + CH] for s in range(0, len(frames), CH))


def _compare_results(got, want):
    assert got["num_frames"] == want["num_frames"]
    np.testing.assert_array_equal(got["keep"], want["keep"])
    m = want["keep"].any(1)
    _close_boxes(got["boxes"], want["boxes"], m)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL_SCORE, rtol=0)
    np.testing.assert_allclose(got["seq_scores"], want["seq_scores"], atol=TOL_SCORE, rtol=0)
    assert (got["path_ids"] != want["path_ids"]).mean() < 0.01
    assert set(got["tracks"]) == set(want["tracks"])
    for tid, wseg in want["tracks"].items():
        gseg = got["tracks"][tid]
        assert [t for t, _, _ in gseg] == [t for t, _, _ in wseg], tid
        _close_boxes(np.stack([b for _, b, _ in gseg]), np.stack([b for _, b, _ in wseg]))
        np.testing.assert_allclose([s for _, _, s in gseg], [s for _, _, s in wseg],
                                   atol=TOL_SCORE, rtol=0)


def _assert_bit_equal(fused, host):
    """The two engines' results equal to the last bit."""
    assert fused["num_frames"] == host["num_frames"]
    for k in ("keep", "boxes", "scores", "path_ids", "seq_scores"):
        np.testing.assert_array_equal(fused[k], host[k], err_msg=k)
    assert set(fused["tracks"]) == set(host["tracks"])
    for tid, hseg in host["tracks"].items():
        fseg = fused["tracks"][tid]
        assert [t for t, _, _ in fseg] == [t for t, _, _ in hseg], tid
        np.testing.assert_array_equal(np.stack([b for _, b, _ in fseg]),
                                      np.stack([b for _, b, _ in hseg]))
        np.testing.assert_array_equal([s for _, _, s in fseg], [s for _, _, s in hseg])


def _preconditions(res, rois):
    assert res["num_frames"] % CH != 0  # a partial final chunk
    segs = res["tracks"].values()
    seed_chunks = {max(seg, key=lambda e: e[2])[0] // CH for seg in segs}
    assert len(seed_chunks) >= 2, seed_chunks
    assert any(min(t for t, _, _ in s) // CH != max(t for t, _, _ in s) // CH for s in segs)
    assert any(s == 0.0 for seg in segs for _, _, s in seg)  # backtracked entries
    kept = res["keep"].any(1)
    assert len(set(kept.sum(1).tolist())) > 1, "slot layout is constant"
    assert len({int((r != 0).any(-1).sum()) for r in rois}) > 1, "roi counts do not vary"
    assert (res["path_ids"] >= 0).any()


def _compare_protos(td, jd, tt, jt, tk, jk):
    assert len(jd["detections"]) > 0 and len(td["detections"]) == len(jd["detections"])
    for a, b in zip(td["detections"], jd["detections"]):
        assert a["frame"] == b["frame"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=TOL_BOX, rtol=0)
        assert [s["class_index"] for s in a["scores"]] == [s["class_index"] for s in b["scores"]]
        np.testing.assert_allclose([s["score"] for s in a["scores"]],
                                   [s["score"] for s in b["scores"]], atol=TOL_SCORE, rtol=0)
    assert [len(t) for t in tt["tracks"]] == [len(t) for t in jt["tracks"]]
    assert tk["method"] == jk["method"] == "stream_tracker"
    assert [[e["frame"] for e in t] for t in tk["tracks"]] == \
        [[e["frame"] for e in t] for t in jk["tracks"]]
    for a, b in zip(tk["tracks"], jk["tracks"]):
        np.testing.assert_allclose([e["bbox"] for e in a], [e["bbox"] for e in b],
                                   atol=TOL_BOX, rtol=0)


def _run_clis(nets, tmp_path, monkeypatch, n_frames, extra=()):
    """Both stream tools over the same JPEG frames and proposals, their
    random weights replaced by the same converted float32 weights; returns
    the argv (without workdir) and each tool's (final, tubelets, track)
    protos."""
    import vdetlib_tpu.cli.stream as jcli
    import vdetlib_tpu.nn.detector as jdetector
    import vdetlib_tpu.video.track as jtrack
    import vdetlib_tpu_torch.cli.stream as tcli
    import vdetlib_tpu_torch.weights as tweights

    sv = make_video(SynthConfig(num_frames=n_frames, height=HW[0], width=HW[1], num_classes=C,
                                seed=9, max_speed=2.0, proposals_per_frame=R), video="clip")
    proto_dump(write_frames(sv, str(tmp_path / "frames")), str(tmp_path / "clip.vid.json"))
    proto_dump(box_proto(sv), str(tmp_path / "clip.box.json"))
    monkeypatch.setattr(jdetector, "init_detector", lambda *a, **k: (nets["jdet"], nets["jdp"]))
    monkeypatch.setattr(jtrack, "init_tracker", lambda *a, **k: (nets["jtrk"], nets["jtp"]))
    monkeypatch.setattr(tweights, "init_detector", lambda *a, **k: nets["tdet"])
    monkeypatch.setattr(tweights, "init_tracker", lambda *a, **k: nets["ttrk"])
    argv = [str(tmp_path / "clip.vid.json"), "--model", "tiny", "--num_classes", str(C),
            "--image_hw", str(HW[0]), str(HW[1]), "--max_rois", str(R), "--chunk", str(CH),
            "--track_slots", str(A), "--seed_thresh", "0.2", *extra]
    assert jcli.main(argv[:1] + [str(tmp_path / "j")] + argv[1:]) == 0
    assert tcli.main(argv[:1] + [str(tmp_path / "t")] + argv[1:] + ["--device", "cpu"]) == 0
    out = {}
    for side in "jt":
        vdir = tmp_path / side / "clip"
        out[side] = [proto_load(str(vdir / f)) for f in ("final.json", "tubelets.json",
                                                        "track.json")]
    return argv, out["j"], out["t"]
