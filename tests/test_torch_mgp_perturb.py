"""Port parity: the staged MGP and perturbation stages and the ``mgp`` tool.

Inputs are seeded easy-tier synthetic videos (96×128, C = 4) with the JAX
package's detections; the models are the float32 tiny detector with
converted weights (tests/torch_fused_common.py). The JAX side runs on the
CPU, the port on the CPU with kernel A's plain version. Bounds:

- ``propagate_dets`` (windows 1 and 2; presets "fastest" and "fast"; T = 8,
  2 and 1): masks and hops exactly, live boxes within 0.5 px (the bf16 flow
  level sums in another order; box-shift bound of tests/test_mgp.py),
  scores within 1e-6 (the same float32 products on the host);
- ``mgp`` with and without its NMS, and with the "accurate" flow pyramid:
  the same (frame, class) entry sequence, boxes within 0.5 px, scores
  within 1e-5; the ``mgp`` tool on
  ``--device cpu`` against the JAX tool over the same protos and frames;
- ``perturb_rescore_arrays`` and ``perturb_rescore_track_proto`` for the
  same seed: probabilities within 2e-3 (the detector bound of
  tests/test_torch_staged.py), best boxes within 1e-2 px wherever the top
  two foreground qualities differ by more than 1e-3, ``perturb_scores``
  class indices equal;
- the three new tools raise without a card when ``--device`` is left at
  ``cuda``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fused_common import HW, f32_nets
from vdetlib_tpu.data.synth import SynthConfig, det_proto_from_gt, make_video, vid_proto_in_memory
from vdetlib_tpu.protos.arrays import det_proto_to_arrays
from vdetlib_tpu.video import mgp as jmgp
from vdetlib_tpu.video import perturb as jperturb
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.video import mgp as tmgp
from vdetlib_tpu_torch.video import perturb as tperturb

torch.set_num_threads(2)

C = 4
N = 16


@pytest.fixture(scope="module")
def video():
    sv = make_video(SynthConfig(num_frames=8, height=HW[0], width=HW[1], num_classes=C, seed=3))
    det = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=3)
    return sv, vid_proto_in_memory(sv), det


@pytest.mark.parametrize("preset", ["fastest", "fast"])
@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("T", [8, 2, 1])
def test_propagate_dets_matches_jax(video, preset, window, T):
    sv, _, det = video
    boxes, scores, mask = (a[:T] for a in det_proto_to_arrays(det, sv.frame_ids, N, C))
    kw = dict(window=window, flow_preset=preset, num_classes=C, max_boxes=N)
    want = jmgp.propagate_dets(sv.frames[:T], boxes, scores, mask, jmgp.MGPOptions(**kw))
    got = tmgp.propagate_dets(sv.frames[:T], boxes, scores, mask, tmgp.MGPOptions(**kw),
                              device="cpu")
    want = [np.asarray(a) for a in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape == (T, N * (2 * window + 1), 4)
    np.testing.assert_array_equal(got[2], want[2])  # masks
    np.testing.assert_array_equal(got[3], want[3])  # hops
    live = want[2]
    assert np.abs(got[0] - want[0])[live].max(initial=0.0) < 0.5
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    if T > 1:  # propagated boxes exist and moved
        hop_live = live & (want[3] != 0)
        assert hop_live.any()
        native = np.concatenate([boxes] * (2 * window + 1), axis=1)
        assert np.abs(want[0] - native)[hop_live].max() > 0.1


def _compare_det_protos(got, want, b_tol=0.5, s_tol=1e-5):
    g, w = got["detections"], want["detections"]
    assert got["video"] == want["video"] and len(g) == len(w) > 0
    assert [(d["frame"], [s["class_index"] for s in d["scores"]]) for d in g] == \
        [(d["frame"], [s["class_index"] for s in d["scores"]]) for d in w]
    db = max(float(np.abs(np.subtract(a["bbox"], b["bbox"])).max()) for a, b in zip(g, w))
    ds = max(abs(x["score"] - y["score"]) for a, b in zip(g, w)
             for x, y in zip(a["scores"], b["scores"]))
    assert db < b_tol and ds < s_tol, (db, ds)


@pytest.mark.parametrize("run_nms", [True, False])
@pytest.mark.parametrize("window", [1, 2])
def test_mgp_matches_jax(video, run_nms, window):
    sv, vid, det = video
    kw = dict(window=window, run_nms=run_nms, num_classes=C, max_boxes=N)
    want = jmgp.mgp(vid, det, jmgp.MGPOptions(**kw), frames_u8=sv.frames)
    got = tmgp.mgp(vid, det, tmgp.MGPOptions(**kw), frames_u8=sv.frames, device="cpu")
    _compare_det_protos(got, want)
    if not run_nms:  # every propagated copy is an entry
        assert len(got["detections"]) > len(det["detections"])


def test_mgp_accurate_preset_matches_jax(video):
    """``mgp`` with the pyramid flow ("accurate": full-resolution float32
    levels, ``flow_levels``/``flow_search`` honoured) at the bounds above."""
    sv, vid, det = video
    kw = dict(window=1, num_classes=C, max_boxes=N, flow_preset="accurate", flow_levels=2)
    want = jmgp.mgp(vid, det, jmgp.MGPOptions(**kw), frames_u8=sv.frames)
    got = tmgp.mgp(vid, det, tmgp.MGPOptions(**kw), frames_u8=sv.frames, device="cpu")
    _compare_det_protos(got, want)
    fastest = tmgp.mgp(vid, det, tmgp.MGPOptions(**dict(kw, flow_preset="fastest")),
                       frames_u8=sv.frames, device="cpu")
    assert fastest != got


def test_mgp_of_one_frame_matches_jax(video):
    sv, vid, det = video
    vid1 = dict(vid, frames=vid["frames"][:1])
    det1 = dict(det, detections=[d for d in det["detections"] if d["frame"] == sv.frame_ids[0]])
    kw = dict(num_classes=C, max_boxes=N)
    want = jmgp.mgp(vid1, det1, jmgp.MGPOptions(**kw), frames_u8=sv.frames[:1])
    got = tmgp.mgp(vid1, det1, tmgp.MGPOptions(**kw), frames_u8=sv.frames[:1], device="cpu")
    _compare_det_protos(got, want)


def test_mgp_tool_matches_jax_tool(video, tmp_path):
    import vdetlib_tpu.cli.mgp as jcli
    import vdetlib_tpu_torch.cli.mgp as tcli
    from vdetlib_tpu.data.synth import write_frames

    sv, _, det = video
    vid = write_frames(sv, str(tmp_path))
    proto_dump(vid, str(tmp_path / "v.json"))
    proto_dump(det, str(tmp_path / "d.json"))
    argv = [str(tmp_path / "v.json"), str(tmp_path / "d.json")]
    flags = ["--num_classes", str(C), "--max_boxes", str(N), "--window", "2",
             "--score_decay", "0.8"]
    assert jcli.main(argv + [str(tmp_path / "j.json")] + flags) == 0
    assert tcli.main(argv + [str(tmp_path / "t.json")] + flags + ["--device", "cpu"]) == 0
    _compare_det_protos(proto_load(str(tmp_path / "t.json")), proto_load(str(tmp_path / "j.json")))


@pytest.mark.parametrize("tool, n_protos", [("mgp", 2), ("rescore", 3), ("seq_nms", 2)])
def test_tools_raise_without_a_card(video, tmp_path, tool, n_protos):
    """``--device`` defaults to ``cuda``: without a card the tool raises
    (it never falls back to the CPU)."""
    import importlib

    from vdetlib_tpu.data.synth import write_frames

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    sv, _, det = video
    vid = write_frames(sv, str(tmp_path))
    trk = {"video": sv.video, "method": "t", "tracks": [[{"frame": int(sv.frame_ids[0]),
                                                          "bbox": [1.0, 1.0, 20.0, 20.0]}]]}
    paths = []
    for name, proto in zip(("v", "d", "k"), (vid, det, trk)[:n_protos]):
        paths.append(str(tmp_path / f"{name}.json"))
        proto_dump(proto, paths[-1])
    cli = importlib.import_module(f"vdetlib_tpu_torch.cli.{tool}")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(paths + [str(tmp_path / "out.json"), "--num_classes", str(C)])


# ------------------------------------------------------------- perturbation


@pytest.fixture(scope="module")
def nets():
    return f32_nets()


def _tracks(sv, seed, K=3):
    rng = np.random.default_rng(seed)
    boxes = (sv.gt_boxes[:K] + rng.normal(0, 3, sv.gt_boxes[:K].shape)).astype(np.float32)
    mask = rng.uniform(size=boxes.shape[:2]) > 0.2
    return boxes, mask


def _qualities(nets, frames, pboxes):
    """JAX's per-perturbation foreground quality (K, T, P) on ``pboxes``."""
    K, T, P = pboxes.shape[:3]
    rois = jnp.transpose(pboxes, (1, 0, 2, 3)).reshape(T, K * P, 4)
    from vdetlib_tpu.nn.detector import preprocess_images

    scores, _ = nets.jdet.apply(nets.jdp, preprocess_images(jnp.asarray(frames), nets.jdet.config),
                                rois)
    probs = np.asarray(jax.nn.softmax(scores, -1)).reshape(T, K, P, -1).transpose(1, 0, 2, 3)
    return probs[..., 1:].max(-1)


def _decided(quality):
    """(K, T): the best perturbation leads the second by more than 1e-3."""
    top2 = np.sort(quality, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > 1e-3


@pytest.mark.parametrize("seed, take_best", [(0, True), (4, False)])
def test_perturb_rescore_arrays_matches_jax(nets, video, seed, take_best):
    sv = video[0]
    frames = sv.frames[:4]
    boxes, mask = _tracks(sv, seed)
    boxes, mask = boxes[:, :4], mask[:, :4]
    kw = dict(seed=seed, take_best_box=take_best)
    js, jb = jperturb.perturb_rescore_arrays(nets.jdet, nets.jdp, jnp.asarray(frames),
                                             jnp.asarray(boxes), jnp.asarray(mask),
                                             jperturb.PerturbOptions(**kw))
    ts, tb = tperturb.perturb_rescore_arrays(nets.tdet, torch.from_numpy(frames),
                                             torch.from_numpy(boxes), torch.from_numpy(mask),
                                             tperturb.PerturbOptions(**kw))
    js, jb, ts, tb = np.asarray(js), np.asarray(jb), ts.numpy(), tb.numpy()
    assert ts.shape == js.shape == boxes.shape[:2] + (C,) and tb.shape == jb.shape
    assert np.abs(ts - js).max() < 2e-3
    assert (ts[~mask] == 0).all()
    if take_best:
        pboxes = jperturb.perturb_boxes(jnp.asarray(boxes), jax.random.PRNGKey(seed),
                                        jperturb.PerturbOptions(**kw), *HW)
        ok = _decided(_qualities(nets, frames, pboxes))
        assert ok.mean() > 0.5
        assert np.abs(tb - jb)[ok].max() < 1e-2
        assert np.abs(tb - boxes).max() > 0.1  # boxes moved to other perturbations
    else:
        np.testing.assert_array_equal(tb, boxes)


def test_perturb_rescore_track_proto_matches_jax(nets, video):
    sv = video[0]
    T = 5
    boxes, mask = _tracks(sv, 7)
    tracks = []
    for k in range(boxes.shape[0]):
        tracks.append([{"frame": int(sv.frame_ids[t]), "bbox": [float(v) for v in boxes[k, t]],
                        "score": 0.8, "anchor": 1} for t in range(T) if mask[k, t]])
    tracks.append({"boxes": tracks[0][:2]})  # a score_proto track
    tp = {"video": sv.video, "method": "t", "tracks": tracks}
    fids = sv.frame_ids[:T]
    opts = dict(seed=2)
    want = jperturb.perturb_rescore_track_proto(nets.jdet, nets.jdp, sv.frames[:T], tp, fids,
                                                jperturb.PerturbOptions(**opts), batch_frames=2)
    got = tperturb.perturb_rescore_track_proto(nets.tdet, sv.frames[:T], tp, fids,
                                               tperturb.PerturbOptions(**opts), batch_frames=2)
    assert {k: v for k, v in got.items() if k != "tracks"} == \
        {k: v for k, v in want.items() if k != "tracks"}
    # the quality margins of each batch's perturbations, as the stage draws them
    from vdetlib_tpu.protos.arrays import track_proto_to_arrays

    kb, _, km = track_proto_to_arrays(tp, fids)
    margins = []
    for s in range(0, T, 2):
        pb = jperturb.perturb_boxes(jnp.asarray(kb[:, s:s + 2]), jax.random.PRNGKey(2),
                                    jperturb.PerturbOptions(**opts), *HW)
        margins.append(_decided(_qualities(nets, sv.frames[s:min(s + 2, T)], pb)))
    decided = np.concatenate(margins, axis=1)
    fmap = {int(f): i for i, f in enumerate(fids)}
    n_checked = 0
    assert len(got["tracks"]) == len(want["tracks"])
    for k, (gt, wt) in enumerate(zip(got["tracks"], want["tracks"])):
        assert len(gt) == len(wt)
        for g, w in zip(gt, wt):
            assert set(g) == set(w) and g["frame"] == w["frame"] and g["anchor"] == w["anchor"]
            assert [s["class_index"] for s in g["perturb_scores"]] == \
                [s["class_index"] for s in w["perturb_scores"]]
            assert abs(g["perturb_scores"][0]["score"] - w["perturb_scores"][0]["score"]) < 2e-3
            if decided[k, fmap[g["frame"]]]:
                assert np.abs(np.subtract(g["bbox"], w["bbox"])).max() < 1e-2
                n_checked += 1
    assert n_checked > 0
    empty = {"video": "v", "tracks": []}
    assert tperturb.perturb_rescore_track_proto(nets.tdet, sv.frames[:T], empty, fids) is empty
