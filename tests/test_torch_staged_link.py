"""Port parity: the staged rescoring and linking stages, the perturbation's
key stream, and three repairs of the card's routes.

Inputs are seeded synthetic videos (96×128, C = 4) with the JAX package's
detections and jittered ground-truth tracks; the JAX side runs on the CPU.
Bounds:

- ``utils/prng.py``: keys, ``split`` and 32-bit ``bits`` bit for bit against
  ``jax.random``; ``uniform`` bit for bit; ``normal`` within 1e-3 (its
  erfinv is not XLA's polynomial);
- ``perturb_boxes`` for the same seed: boxes within 1e-2 px, the first
  perturbation the (clipped) box itself;
- ``rescore_arrays`` with ``trk_cls_scores`` and ``tubelet_rescore`` (with
  and without a perturbed track_proto, ``tubelet_boxes``,
  ``min_matched_frac``, ``stat_floor``): the score_proto and det_proto of the
  same structure, entry for entry, values within 1e-5;
- ``seq_nms_batch_host``: path ids exactly, scores within 1e-5;
  ``seq_nms_video`` with both backends: path ids (the tubelets' frames and
  classes) exactly, boxes exactly, scores within 1e-5;
- the ``rescore`` and ``seq_nms`` tools on ``--device cpu`` against the JAX
  tools over the same protos, under the same bounds;
- the repairs: the NMS routes by slot count; ``nms_grouped`` at 576 slots
  in 30 groups equals JAX's keep sets exactly; frame NMS ``xla`` above
  kernel D's limit takes the fixpoint and equals ``host``; ``flow_video``
  of one frame is JAX's empty field and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, det_proto_from_gt, make_video, vid_proto_in_memory
from vdetlib_tpu.kernels import seq_nms_host as jsnh
from vdetlib_tpu.video import link as jlink
from vdetlib_tpu.video import perturb as jperturb
from vdetlib_tpu.video import rescore as jrescore
from vdetlib_tpu_torch.kernels import seq_nms_host as tsnh
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.utils import prng
from vdetlib_tpu_torch.video import link as tlink
from vdetlib_tpu_torch.video import perturb as tperturb
from vdetlib_tpu_torch.video import rescore as trescore

torch.set_num_threads(2)

HW = (96, 128)
C = 4


# ------------------------------------------------------------- key stream


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, -3, 2**31 - 1])
def test_prng_keys_split_and_bits_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(key, num), np.asarray(jax.random.split(jkey, num)))
    for shape in ((1,), (4,), (5, 9, 8), (3, 2, 7)):
        np.testing.assert_array_equal(
            prng.bits(key, shape), np.asarray(jax.random.bits(jkey, shape, dtype=jnp.uint32)))
        np.testing.assert_array_equal(prng.uniform(key, shape),
                                      np.asarray(jax.random.uniform(jkey, shape)))


@pytest.mark.parametrize("seed", [0, 5])
def test_prng_normal_within_1e_3_of_jax(seed):
    for k in jax.random.split(jax.random.PRNGKey(seed), 3):
        for shape in ((5, 9, 8), (64, 30, 8)):
            want = np.asarray(jax.random.normal(k, shape))
            got = prng.normal(np.asarray(k), shape)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.abs(got - want).max() < 1e-3


def _boxes(rng, shape):
    xy = rng.uniform(-10, 100, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(3, 60, shape + (2,))], -1).astype(np.float32)


@pytest.mark.parametrize("seed, kw", [(0, {}), (3, {"num_perturb": 5, "scale_sigma": 0.3}),
                                      (11, {"shift_sigma": 0.2})])
def test_perturb_boxes_matches_jax(seed, kw):
    boxes = _boxes(np.random.default_rng(seed), (5, 9))
    jopts = jperturb.PerturbOptions(seed=seed, **kw)
    want = np.asarray(jperturb.perturb_boxes(jnp.asarray(boxes), jax.random.PRNGKey(seed), jopts,
                                             HW[0], HW[1]))
    got = tperturb.perturb_boxes(torch.from_numpy(boxes), prng.PRNGKey(seed),
                                 tperturb.PerturbOptions(seed=seed, **kw), HW[0], HW[1]).numpy()
    assert got.shape == want.shape == (5, 9, jopts.num_perturb, 4)
    assert np.abs(got - want).max() < 1e-2
    clipped = np.clip(boxes, 0, [HW[1] - 1, HW[0] - 1] * 2)
    np.testing.assert_allclose(got[..., 0, :], clipped, atol=1e-4)
    assert np.abs(got[..., 1:, :] - clipped[..., None, :]).max() > 1.0  # the others move


def test_perturb_boxes_takes_its_noise_as_tensors():
    boxes = torch.from_numpy(_boxes(np.random.default_rng(2), (3, 4)))
    opts = tperturb.PerturbOptions(seed=9)
    noise = [torch.from_numpy(prng.normal(k, (3, 4, 8))) for k in prng.split(prng.PRNGKey(9), 3)]
    drawn = tperturb.perturb_boxes(boxes, prng.PRNGKey(9), opts, *HW)
    given = tperturb.perturb_boxes(boxes, None, opts, *HW, noise=noise)
    assert torch.equal(drawn, given)


# ------------------------------------------------------------- rescoring


def _video(seed, T=8):
    sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=C,
                                seed=seed))
    return sv, vid_proto_in_memory(sv)


def _track_proto(sv, seed, perturbed=False, dict_tracks=False):
    """Jittered ground-truth tracks (each with a gap), plus a short stray
    track; with ``perturbed`` some boxes carry ``perturb_scores``."""
    rng = np.random.default_rng(seed)
    tracks = []
    K, T = sv.gt_boxes.shape[:2]
    for k in range(K):
        gap = int(rng.integers(1, T - 1))
        entries = []
        for t, fid in enumerate(sv.frame_ids):
            if t == gap:
                continue
            e = {"frame": int(fid), "bbox": [float(v) for v in sv.gt_boxes[k, t]
                                             + rng.normal(0, 2, 4)], "score": 0.9}
            if perturbed and rng.uniform() < 0.6:
                e["perturb_scores"] = [{"class_index": int(rng.integers(1, C)),
                                        "score": float(rng.uniform(0.2, 1.0))}]
            entries.append(e)
        tracks.append({"boxes": entries} if dict_tracks else entries)
    stray = [{"frame": int(f), "bbox": [5.0, 5.0, 30.0, 30.0], "score": 0.5}
             for f in sv.frame_ids[:3]]
    tracks.append({"boxes": stray} if dict_tracks else stray)
    return {"video": sv.video, "method": "test", "tracks": tracks}


def test_rescore_arrays_with_track_class_scores_matches_jax():
    rng = np.random.default_rng(4)
    T, N, K = 7, 10, 5
    det_boxes = _boxes(rng, (T, N))
    det_scores = rng.uniform(0, 1, (T, N, C)).astype(np.float32)
    det_mask = rng.uniform(size=(T, N)) > 0.25
    det_scores *= det_mask[..., None]
    trk_boxes = (det_boxes[:, rng.integers(0, N, K)].transpose(1, 0, 2)
                 + rng.normal(0, 3, (K, T, 4))).astype(np.float32)
    trk_mask = rng.uniform(size=(K, T)) > 0.3
    trk_cls = (rng.uniform(0, 1, (K, T, C)) * (rng.uniform(size=(K, T, 1)) > 0.5)).astype(
        np.float32)
    args = (det_boxes, det_scores, det_mask, trk_boxes, trk_mask)
    kw = dict(top_ratio=0.5, boost="max", min_matched_frac=0.2, stat_floor=2.0)
    jn, js, jm = jrescore.rescore_arrays(*(jnp.asarray(a) for a in args), 0.5, 0.8,
                                         trk_cls_scores=jnp.asarray(trk_cls), **kw)
    tn, ts, tm = trescore.rescore_arrays(*(torch.from_numpy(a) for a in args), 0.5, 0.8,
                                         trk_cls_scores=torch.from_numpy(trk_cls), **kw)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the evidence reaches the statistic: without it the statistics differ
    ts0 = trescore.rescore_arrays(*(torch.from_numpy(a) for a in args), 0.5, 0.8, **kw)[1]
    assert not torch.allclose(ts0, ts)


def _compare_det_protos(got, want, tol=1e-5):
    assert got["video"] == want["video"]
    g, w = got["detections"], want["detections"]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a["frame"] == b["frame"]
        assert [(s["class"], s["class_index"]) for s in a["scores"]] == \
            [(s["class"], s["class_index"]) for s in b["scores"]]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=tol, rtol=0)
        np.testing.assert_allclose([s["score"] for s in a["scores"]],
                                   [s["score"] for s in b["scores"]], atol=tol, rtol=0)


def _compare_score_protos(got, want):
    assert {k: v for k, v in got.items() if k != "tracks"} == \
        {k: v for k, v in want.items() if k != "tracks"}
    assert len(got["tracks"]) == len(want["tracks"])
    for a, b in zip(got["tracks"], want["tracks"]):
        assert a["boxes"] == b["boxes"]
        assert [s["class_index"] for s in a["scores"]] == [s["class_index"] for s in b["scores"]]
        np.testing.assert_allclose([s["score"] for s in a["scores"]],
                                   [s["score"] for s in b["scores"]], atol=1e-5, rtol=0)


RESCORE_CASES = {
    "defaults": ({}, False),
    "perturbed": ({}, True),
    "tubelet_boxes": ({"tubelet_boxes": True}, True),
    "gate_floor_mean": ({"min_matched_frac": 0.5, "stat_floor": 4, "boost": "mean",
                         "bg_decay": 0.7, "tubelet_boxes": True}, False),
    "max_tracks": ({"max_tracks": 2, "top_ratio": 0.3}, True),
}


@pytest.mark.parametrize("case", sorted(RESCORE_CASES))
def test_tubelet_rescore_matches_jax(case):
    kw, perturbed = RESCORE_CASES[case]
    sv, vid = _video(21)
    det = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=3, drop_rate=0.3)
    trk = _track_proto(sv, 21, perturbed=perturbed)
    kw = dict(kw, num_classes=C, max_boxes=16)
    jsp, jdet = jrescore.tubelet_rescore(vid, det, trk, jrescore.RescoreOptions(**kw))
    tsp, tdet = trescore.tubelet_rescore(vid, det, trk, trescore.RescoreOptions(**kw),
                                         device="cpu")
    _compare_score_protos(tsp, jsp)
    _compare_det_protos(tdet, jdet)
    assert len(jdet["detections"]) > 0
    if kw.get("tubelet_boxes"):  # gaps were filled past the detection slots
        n_in = sum(min(16, sum(d["frame"] == f for d in det["detections"])) for f in sv.frame_ids)
        assert len(jdet["detections"]) > n_in or case == "gate_floor_mean"


def test_track_bridges_match_jax_on_list_and_dict_tracks():
    """``track_proto_to_arrays`` and ``track_cls_scores_to_arrays`` read list
    tracks and score_proto ``{"boxes": [...]}`` tracks, as JAX's do;
    ``arrays_to_track_proto`` writes what JAX's writes."""
    from vdetlib_tpu.protos import arrays as jarr
    from vdetlib_tpu_torch.protos import arrays as tarr

    sv, _ = _video(22)
    fids = list(sv.frame_ids)[1:]  # a frame of the tracks outside the video
    for dict_tracks in (False, True):
        trk = _track_proto(sv, 22, perturbed=True, dict_tracks=dict_tracks)
        for mt in (None, 2):
            for g, w in zip(tarr.track_proto_to_arrays(trk, fids, max_tracks=mt),
                            jarr.track_proto_to_arrays(trk, fids, max_tracks=mt)):
                np.testing.assert_array_equal(g, w)
            (g, gf), (w, wf) = (f(trk, fids, C, max_tracks=mt) for f in (
                tarr.track_cls_scores_to_arrays, jarr.track_cls_scores_to_arrays))
            np.testing.assert_array_equal(g, w)
            assert gf == wf is True
    b, s_, m = jarr.track_proto_to_arrays(_track_proto(sv, 22), fids)
    assert tarr.arrays_to_track_proto(b, s_, m, fids, "v", "m", anchors=list(range(len(b)))) == \
        jarr.arrays_to_track_proto(b, s_, m, fids, "v", "m", anchors=list(range(len(b))))


def test_tubelet_rescore_without_tracks_matches_jax():
    sv, vid = _video(22)
    det = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=2)
    trk = {"video": sv.video, "method": "none", "tracks": []}
    opts = dict(num_classes=C, max_boxes=16, bg_decay=0.5)
    jsp, jdet = jrescore.tubelet_rescore(vid, det, trk, jrescore.RescoreOptions(**opts))
    tsp, tdet = trescore.tubelet_rescore(vid, det, trk, trescore.RescoreOptions(**opts),
                                         device="cpu")
    _compare_det_protos(tdet, jdet)
    _compare_score_protos(tsp, jsp)
    assert len(tdet["detections"]) > 0 and tsp["tracks"] == []


# ------------------------------------------------------------- linking


def _seq_inputs(seed, T=8, N=12, C_=3):
    rng = np.random.default_rng(seed)
    base = _boxes(rng, (N,))
    boxes = (base[None] + rng.normal(0, 2.0, (T, N, 1)) * np.float32([1, 0.5, 1, 0.5])).astype(
        np.float32)
    boxes[:, 1] = boxes[:, 0]  # duplicates: ties in the DP
    scores = (np.round(rng.uniform(0.05, 1, (C_, T, N)) * 4) / 4).astype(np.float32)
    mask = rng.uniform(size=(C_, T, N)) > 0.2
    return boxes, scores, mask


@pytest.mark.parametrize("seed, rescore, max_paths",
                         [(0, "avg", 20), (1, "max", 20), (2, "avg", 2)])
def test_seq_nms_batch_host_matches_jax(seed, rescore, max_paths):
    boxes, scores, mask = _seq_inputs(seed)
    jo, jp = jsnh.seq_nms_batch_host(boxes, scores, mask, 0.5, 0.3, max_paths=max_paths,
                                     rescore=rescore)
    to, tp = tsnh.seq_nms_batch_host(boxes, scores, mask, 0.5, 0.3, max_paths=max_paths,
                                     rescore=rescore)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    assert tp.dtype == np.int32 and to.dtype == np.float32 and (tp >= 0).any()


def _compare_tubelets(got, want):
    assert {k: v for k, v in got.items() if k != "tracks"} == \
        {k: v for k, v in want.items() if k != "tracks"}
    assert len(got["tracks"]) == len(want["tracks"]) > 0
    for a, b in zip(got["tracks"], want["tracks"]):
        assert [(e["frame"], e["class_index"], e["bbox"]) for e in a] == \
            [(e["frame"], e["class_index"], e["bbox"]) for e in b]
        np.testing.assert_allclose([e["score"] for e in a], [e["score"] for e in b], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("kw", [{}, {"rescore": "max", "max_paths": 3, "min_score": 0.3}])
def test_seq_nms_video_matches_jax(backend, kw):
    sv, vid = _video(23, T=9)
    det = det_proto_from_gt(sv, dets_per_object=3, distractors_per_frame=3)
    kw = dict(kw, num_classes=C, max_boxes=16)
    jdet, jtub = jlink.seq_nms_video(vid, det, jlink.LinkOptions(backend=backend, **kw))
    tdet, ttub = tlink.seq_nms_video(vid, det, tlink.LinkOptions(backend=backend, **kw),
                                     device="cpu")
    _compare_det_protos(tdet, jdet)
    _compare_tubelets(ttub, jtub)


def test_seq_nms_video_backends_agree():
    sv, vid = _video(24, T=9)
    det = det_proto_from_gt(sv, dets_per_object=3, distractors_per_frame=4)
    opts = dict(num_classes=C, max_boxes=16)
    ddet, dtub = tlink.seq_nms_video(vid, det, tlink.LinkOptions(backend="device", **opts),
                                     device="cpu")
    hdet, htub = tlink.seq_nms_video(vid, det, tlink.LinkOptions(backend="host", **opts))
    _compare_det_protos(ddet, hdet)
    _compare_tubelets(dtub, htub)
    with pytest.raises(ValueError):
        tlink.seq_nms_video(vid, det, tlink.LinkOptions(backend="xla", **opts), device="cpu")


# ------------------------------------------------------------- tools


def _write(tmp_path, **protos):
    paths = {}
    for name, proto in protos.items():
        paths[name] = str(tmp_path / f"{name}.json")
        proto_dump(proto, paths[name])
    return paths


def test_rescore_tool_matches_jax_tool(tmp_path):
    import vdetlib_tpu.cli.rescore as jcli
    import vdetlib_tpu_torch.cli.rescore as tcli

    sv, vid = _video(25)
    det = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=3)
    p = _write(tmp_path, vid=vid, det=det, trk=_track_proto(sv, 25, perturbed=True))
    flags = ["--num_classes", str(C), "--max_boxes", "16", "--bg_decay", "0.8",
             "--stat_floor", "2", "--min_matched_frac", "0.3"]
    for cli, tag, extra in ((jcli, "j", []), (tcli, "t", ["--device", "cpu"])):
        assert cli.main([p["vid"], p["det"], p["trk"], str(tmp_path / f"{tag}_score.json"),
                         "--det_output", str(tmp_path / f"{tag}_det.json")] + flags + extra) == 0
    _compare_score_protos(proto_load(str(tmp_path / "t_score.json")),
                          proto_load(str(tmp_path / "j_score.json")))
    _compare_det_protos(proto_load(str(tmp_path / "t_det.json")),
                        proto_load(str(tmp_path / "j_det.json")))


@pytest.mark.parametrize("backend", ["device", "host"])
def test_seq_nms_tool_matches_jax_tool(tmp_path, backend):
    import vdetlib_tpu.cli.seq_nms as jcli
    import vdetlib_tpu_torch.cli.seq_nms as tcli

    sv, vid = _video(26, T=9)
    p = _write(tmp_path, vid=vid, det=det_proto_from_gt(sv, dets_per_object=3,
                                                        distractors_per_frame=3))
    flags = ["--num_classes", str(C), "--max_boxes", "16", "--max_paths", "10"]
    assert jcli.main([p["vid"], p["det"], str(tmp_path / "j.json"), "--track_output",
                      str(tmp_path / "jt.json")] + flags) == 0
    assert tcli.main([p["vid"], p["det"], str(tmp_path / "t.json"), "--track_output",
                      str(tmp_path / "tt.json"), "--backend", backend, "--device", "cpu"]
                     + flags) == 0
    _compare_det_protos(proto_load(str(tmp_path / "t.json")), proto_load(str(tmp_path / "j.json")))
    _compare_tubelets(proto_load(str(tmp_path / "tt.json")), proto_load(str(tmp_path / "jt.json")))


# ------------------------------------------------------------- repairs


def test_nms_routes_by_slot_count():
    from vdetlib_tpu_torch.kernels.nms import batched_route, grouped_route
    from vdetlib_tpu_torch.kernels.nms_sorted import MAX_SLOTS

    assert MAX_SLOTS == 8192
    assert [grouped_route(n) for n in (1, 192, 512, 513, 576, 4096)] == \
        ["kernel"] * 3 + ["fixpoint"] * 3
    assert [batched_route(n) for n in (1, 128, 129, 512, 513, 8192, 8193, 8200)] == \
        ["batched", "batched", "grouped", "grouped", "sorted", "sorted", "fixpoint", "fixpoint"]


def test_nms_grouped_at_576_slots_matches_jax():
    """The fused dedup's size at ``mgp_window`` 4 (64 × 9 slots), in 30
    class groups, with ties, duplicates, invalid and padded slots: the JAX
    ``nms_grouped`` runs its XLA fixpoint here, and the port's keep sets
    equal it."""
    from chip_smoke import nms_problem
    from vdetlib_tpu.kernels.nms import nms_grouped as j_nms_grouped
    from vdetlib_tpu_torch.kernels.nms import nms_grouped

    boxes, scores, valid, grp = nms_problem(3, 576, seed=5, groups=30)
    want = np.asarray(j_nms_grouped(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                    jnp.asarray(grp), 0.3))
    got = nms_grouped(*(torch.from_numpy(a) for a in (boxes, scores, valid, grp)), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum() and (want & ~valid).sum() == 0


def test_fixpoint_passes_equal_one_pass():
    from chip_smoke import nms_problem
    from vdetlib_tpu_torch.kernels.nms import fixpoint_passes, nms_unsorted_fixpoint

    args = [torch.from_numpy(a) for a in nms_problem(7, 40, seed=6, groups=3)]
    one = nms_unsorted_fixpoint(*args[:3], 0.3, groups=args[3])
    passes = fixpoint_passes(lambda b, s, v, g: nms_unsorted_fixpoint(b, s, v, 0.3, groups=g),
                             *args, max_elems=2 * 40 * 40)
    assert torch.equal(one, passes)


def test_frame_nms_xla_above_the_sorted_kernels_limit_takes_the_fixpoint(monkeypatch):
    """With D's limit lowered below the problems' size, ``xla`` runs the
    sort-free fixpoint in passes (the route above 8,192 slots on a card)
    and equals ``host``."""
    from vdetlib_tpu_torch.kernels import nms as tnms
    from vdetlib_tpu_torch.video import frame_nms as tfn

    calls = []
    plain = tnms.nms_unsorted_fixpoint

    def spy(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(tfn, "_SORTED_MAX", 16)
    monkeypatch.setattr(tfn, "nms_unsorted_fixpoint", spy)
    monkeypatch.setattr(tfn, "FIXPOINT_ELEMS", 5 * 24 * 24)
    sv, vid = _video(27, T=6)
    det = det_proto_from_gt(sv, dets_per_object=4, distractors_per_frame=6)
    want = tfn.frame_nms(vid, det, thresh=0.3, backend="host")
    got = tfn.frame_nms(vid, det, thresh=0.3, backend="xla", max_boxes=24, device="cpu")
    assert got == want and len(calls) > 1 and all(s[1] == 24 for s in calls)


@pytest.mark.parametrize("preset", ["fast", "fastest"])
@pytest.mark.parametrize("upsample", [True, False])
def test_flow_video_of_one_frame_is_empty(preset, upsample, monkeypatch):
    """JAX's empty ``(0, h, w, 2)`` field, without a call of the level (on a
    card kernel A's wrapper refuses zero pairs)."""
    from vdetlib_tpu.kernels.flow import flow_video as j_flow_video
    from vdetlib_tpu_torch.kernels import flow as tflow

    def no_level(*a, **k):
        raise AssertionError("flow_level called for a one-frame video")

    frames = np.random.default_rng(0).integers(0, 255, (1, 36, 52, 3)).astype(np.uint8)
    want = j_flow_video(jnp.asarray(frames), preset=preset, upsample=upsample)
    monkeypatch.setattr(tflow, "flow_level", no_level)
    got = tflow.flow_video(torch.from_numpy(frames), preset=preset, upsample=upsample)
    assert tuple(got.shape) == want.shape and got.shape[0] == 0
    assert got.dtype == torch.float32 and got.device == torch.device("cpu")
