"""Port parity: the staged detection and tracking stages and their tools.

Frames are written to ``tmp_path`` as JPEGs and both packages read them
back (cv2), as tests/test_detector.py does; the models are the tiny float32
detector and the float32 tracker with converted weights. Bounds:

- ``_detect_step(net_hw)`` (device resize) and ``_detect_step_pyramid``
  against the JAX functions, and ``det_vid`` (plain, ``device_resize``,
  pyramid) entry by entry: the bounds of tests/test_torch_detector.py for
  the float32 backbone, probabilities 2e-3 and boxes 0.25 px in network
  pixels; the (frame, class) sequence of the entries exactly;
- ``track_from_det`` at strides 1 and 2, without and with detection
  snapping: track count, frames and anchors exactly, boxes 0.5 px (the
  float32 ``track_batch`` bound of tests/test_torch_track.py) and scores
  5e-3 (the conf bound of tests/test_track.py's scan comparisons: a
  rollout of 9 steps drifts);
- the ``detect`` and ``track`` tools (``track`` also with
  ``--snap_weight``) on ``--device cpu`` against the JAX tools with the
  same weights, under the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, box_proto, det_proto_from_gt, make_video, write_frames
from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.nn.backbone import BackboneConfig as JBackboneConfig
from vdetlib_tpu.nn.detector import init_detector as jinit_detector
from vdetlib_tpu.nn.presets import detector_preset as jpreset
from vdetlib_tpu.video import detect as jdetect
from vdetlib_tpu.video import track as jtrack
from vdetlib_tpu_torch.nn.detector import Detector
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.video import detect as tdetect
from vdetlib_tpu_torch.video import track as ttrack
from vdetlib_tpu_torch.weights import detector_state_from_flax, tracker_state_from_flax

torch.set_num_threads(2)

HW = (96, 128)
R, C = 16, 4
P_TOL, B_TOL = 2e-3, 0.25
PYRAMID = (0.75, 1.0, 1.25)


@pytest.fixture(scope="module")
def dets():
    """The tiny float32 detector in both packages (regressor scaled by 0.1,
    as in tests/test_torch_detector.py)."""
    jcfg = jpreset("tiny", num_classes=C).__class__(
        num_classes=C, backbone=JBackboneConfig(
            stem_features=16, stage_sizes=(1, 1, 1), stage_features=(32, 64, 128),
            dtype=jnp.float32,
        ), head_hidden=128,
    )
    jmodel, jparams = jinit_detector(jcfg, HW, max_rois=R, seed=0)
    jparams = jax.tree.map(np.asarray, jparams)
    bbox = jparams["params"]["head"]["bbox"]
    bbox["kernel"] = bbox["kernel"] * np.float32(0.1)
    tmodel = Detector(detector_preset("tiny", num_classes=C, dtype=torch.float32))
    tmodel.load_state_dict(detector_state_from_flax(jparams))
    return jmodel, jparams, tmodel.eval()


@pytest.fixture(scope="module")
def trackers():
    jcfg = jtn.TrackerConfig(dtype=jnp.float32)
    jmodel, jparams = jtrack.init_tracker(jcfg, image_hw=HW, seed=0)
    tmodel = TrackerNet(TrackerConfig(dtype=torch.float32))
    tmodel.load_state_dict(tracker_state_from_flax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel.eval()


def _video(tmp_path, name, hw, T, seed):
    sv = make_video(SynthConfig(num_frames=T, height=hw[0], width=hw[1], num_classes=C,
                                seed=seed, proposals_per_frame=R), video=name)
    return sv, write_frames(sv, str(tmp_path)), box_proto(sv)


def _rois(seed, T, hw):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-5, hw[1] - 20, (T, R))
    y1 = rng.uniform(-5, hw[0] - 20, (T, R))
    wh = rng.uniform(6, 60, (T, R, 2))
    return np.concatenate([np.stack([x1, y1], -1), np.stack([x1, y1], -1) + wh],
                          -1).astype(np.float32)


def _close(got, want, p_tol=P_TOL, b_tol=B_TOL):
    (tp, tb), (jp, jb) = got, want
    tp, tb = tp.numpy(), tb.numpy()
    jp, jb = np.asarray(jp), np.asarray(jb)
    assert tp.shape == jp.shape and tb.shape == jb.shape
    dp, db = np.abs(tp - jp).max(), np.abs(tb - jb).max()
    assert dp < p_tol and db < b_tol, (dp, db)


@pytest.mark.parametrize("native", [(192, 256), (84, 112)], ids=["down", "up"])
def test_detect_step_device_resize_matches_jax(dets, native):
    jmodel, jparams, tmodel = dets
    sv = make_video(SynthConfig(num_frames=3, height=native[0], width=native[1], seed=4))
    rois = _rois(4, 3, HW)
    want = jdetect._detect_step(jmodel, jparams, jnp.asarray(sv.frames), jnp.asarray(rois),
                                True, net_hw=HW)
    with torch.no_grad():
        got = tdetect._detect_step(tmodel, torch.from_numpy(sv.frames), torch.from_numpy(rois),
                                   True, net_hw=HW)
    _close(got, want)


@pytest.mark.parametrize("regress", [True, False])
def test_detect_step_pyramid_matches_jax(dets, regress):
    jmodel, jparams, tmodel = dets
    sv = make_video(SynthConfig(num_frames=2, height=HW[0], width=HW[1], seed=5))
    rois = _rois(5, 2, HW)
    want = jdetect._detect_step_pyramid(jmodel, jparams, jnp.asarray(sv.frames),
                                        jnp.asarray(rois), regress, PYRAMID, net_hw=HW)
    with torch.no_grad():
        got = tdetect._detect_step_pyramid(tmodel, torch.from_numpy(sv.frames),
                                           torch.from_numpy(rois), regress, PYRAMID, net_hw=HW)
    _close(got, want)


def _compare_det_protos(got, want, b_tol=B_TOL):
    assert got["video"] == want["video"]
    g, w = got["detections"], want["detections"]
    assert len(g) == len(w) > 0
    assert [(d["frame"], d["scores"][0]["class_index"]) for d in g] == \
        [(d["frame"], d["scores"][0]["class_index"]) for d in w]
    ds = max(abs(a["scores"][0]["score"] - b["scores"][0]["score"]) for a, b in zip(g, w))
    db = max(float(np.abs(np.subtract(a["bbox"], b["bbox"])).max()) for a, b in zip(g, w))
    assert ds < P_TOL and db < b_tol, (ds, db)


@pytest.mark.parametrize("mode", ["plain", "device_resize", "pyramid"])
def test_det_vid_matches_jax(dets, tmp_path, mode):
    jmodel, jparams, tmodel = dets
    native = (2 * HW[0], 2 * HW[1]) if mode == "device_resize" else HW
    _, vid, bp = _video(tmp_path, f"dv_{mode}", native, T=5, seed=6)
    kw = dict(batch_size=2, max_rois=R, image_hw=HW, score_thresh=0.0)  # 5 frames: a padded tail
    kw.update({"device_resize": dict(device_resize=True), "pyramid": dict(pyramid=PYRAMID),
               "plain": {}}[mode])
    want = jdetect.det_vid(jmodel, jparams, vid, bp, jdetect.DetectOptions(**kw))
    got = tdetect.det_vid(tmodel, vid, bp, tdetect.DetectOptions(**kw))
    # boxes are written in native pixels: the network-pixel bound scales with them
    _compare_det_protos(got, want, B_TOL * native[0] / HW[0])


@pytest.mark.parametrize("mode", ["plain", "device_resize"])
def test_det_vid_in_memory_frames_equal_the_files(dets, tmp_path, mode):
    """``frames_u8`` (the frames the loader decodes) gives the det_proto the
    files give, entry for entry; frames off ``image_hw`` are refused."""
    from vdetlib_tpu_torch.data.loader import FrameLoader

    tmodel = dets[2]
    native = (2 * HW[0], 2 * HW[1]) if mode == "device_resize" else HW
    _, vid, bp = _video(tmp_path, f"mem_{mode}", native, T=5, seed=7)
    opts = tdetect.DetectOptions(batch_size=2, max_rois=R, image_hw=HW,
                                 device_resize=mode == "device_resize")
    loader = FrameLoader(vid)
    frames = np.stack([img for _, img, _ in loader.iter_frames()])
    loader.close()
    want = tdetect.det_vid(tmodel, vid, bp, opts)
    assert tdetect.det_vid(tmodel, vid, bp, opts, frames_u8=frames) == want
    with pytest.raises(ValueError):
        tdetect.det_vid(tmodel, vid, bp, opts, frames_u8=frames[:, ::2, ::2] if mode == "plain"
                        else frames[:3])


def test_detect_arrays_matches_jax(dets):
    jmodel, jparams, tmodel = dets
    sv = make_video(SynthConfig(num_frames=5, height=HW[0], width=HW[1], seed=8))
    rois = _rois(8, 5, HW)
    mask = np.random.default_rng(8).uniform(size=(5, R)) > 0.2
    opts = dict(batch_size=2, max_rois=R, image_hw=HW)
    want = jdetect.detect_arrays(jmodel, jparams, sv.frames, rois, mask,
                                 jdetect.DetectOptions(**opts))
    got = tdetect.detect_arrays(tmodel, sv.frames, rois, mask, tdetect.DetectOptions(**opts))
    _close(tuple(torch.from_numpy(g) for g in got), want)


def _compare_track_protos(got, want):
    assert got["video"] == want["video"] and got["method"] == want["method"]
    assert len(got["tracks"]) == len(want["tracks"]) > 1
    for gt, wt in zip(got["tracks"], want["tracks"]):
        assert [(e["frame"], e["anchor"]) for e in gt] == [(e["frame"], e["anchor"]) for e in wt]
        db = max(float(np.abs(np.subtract(a["bbox"], b["bbox"])).max()) for a, b in zip(gt, wt))
        ds = max(abs(a["score"] - b["score"]) for a, b in zip(gt, wt))
        assert db < 0.5 and ds < 5e-3, (db, ds)


def _track_inputs(tmp_path, name):
    sv, vid, _ = _video(tmp_path, name, HW, T=9, seed=9)
    return sv, vid, det_proto_from_gt(sv, dets_per_object=3, distractors_per_frame=4)


@pytest.mark.parametrize("stride", [1, 2])
def test_track_from_det_matches_jax(trackers, tmp_path, stride):
    jmodel, jparams, tmodel = trackers
    _, vid, det = _track_inputs(tmp_path, f"tr{stride}")
    kw = dict(max_tracks=7, anchors_per_round=3, frame_stride=stride, batch_size=4)
    want = jtrack.track_from_det(jmodel, jparams, vid, det, jtn.TrackerConfig(),
                                 jtrack.TrackOptions(**kw))
    got = ttrack.track_from_det(tmodel, vid, det, TrackerConfig(), ttrack.TrackOptions(**kw))
    _compare_track_protos(got, want)
    assert len(got["tracks"]) > 3  # more than one round ran


def test_track_from_det_three_scales_matches_jax(trackers, tmp_path):
    """Scale-adaptive tracking (``num_scales`` 3) through the whole stage,
    each round's scan the plain loop, as JAX runs its XLA scan."""
    jmodel, jparams, tmodel = trackers
    _, vid, det = _track_inputs(tmp_path, "tr3")
    kw = dict(max_tracks=7, anchors_per_round=3, batch_size=4)
    want = jtrack.track_from_det(jmodel, jparams, vid, det, jtn.TrackerConfig(num_scales=3),
                                 jtrack.TrackOptions(**kw))
    got = ttrack.track_from_det(tmodel, vid, det, TrackerConfig(num_scales=3),
                                ttrack.TrackOptions(**kw))
    _compare_track_protos(got, want)


def test_track_from_det_in_memory_frames_equal_the_files(trackers, tmp_path):
    from vdetlib_tpu_torch.data.loader import FrameLoader

    _, vid, det = _track_inputs(tmp_path, "trm")
    loader = FrameLoader(vid)
    frames = np.stack([img for _, img, _ in loader.iter_frames()])
    loader.close()
    opts = ttrack.TrackOptions(max_tracks=4, anchors_per_round=2, batch_size=4)
    want = ttrack.track_from_det(trackers[2], vid, det, TrackerConfig(), opts)
    assert ttrack.track_from_det(trackers[2], vid, det, TrackerConfig(), opts,
                                 frames_u8=frames) == want


@pytest.mark.parametrize("stride", [1, 2])
def test_track_from_det_snap_weight_matches_jax(trackers, tmp_path, stride):
    """Detection snapping: each round's scan blends the boxes toward the
    anchor candidates (per-frame arrays padded to 8 slots) as JAX's does."""
    jmodel, jparams, tmodel = trackers
    _, vid, det = _track_inputs(tmp_path, f"trs{stride}")
    kw = dict(max_tracks=7, anchors_per_round=3, frame_stride=stride, batch_size=4,
              snap_weight=0.5)
    want = jtrack.track_from_det(jmodel, jparams, vid, det, jtn.TrackerConfig(),
                                 jtrack.TrackOptions(**kw))
    got = ttrack.track_from_det(tmodel, vid, det, TrackerConfig(), ttrack.TrackOptions(**kw))
    _compare_track_protos(got, want)
    plain = ttrack.track_from_det(tmodel, vid, det, TrackerConfig(),
                                  ttrack.TrackOptions(**dict(kw, snap_weight=0.0)))
    boxes = lambda tp: [[e["bbox"] for e in t] for t in tp["tracks"]]  # noqa: E731
    assert boxes(plain) != boxes(got), "snapping changed no box"


def test_detect_tool_matches_jax_tool(dets, tmp_path, monkeypatch):
    import vdetlib_tpu.cli.detect as jcli
    import vdetlib_tpu.nn.detector as jdetector
    import vdetlib_tpu_torch.cli.detect as tcli
    import vdetlib_tpu_torch.weights as tweights

    jmodel, jparams, tmodel = dets
    _, vid, bp = _video(tmp_path, "tool", HW, T=3, seed=11)
    proto_dump(vid, str(tmp_path / "v.json"))
    proto_dump(bp, str(tmp_path / "b.json"))
    monkeypatch.setattr(jdetector, "init_detector", lambda *a, **k: (jmodel, jparams))
    monkeypatch.setattr(tweights, "init_detector", lambda *a, **k: tmodel)
    argv = [str(tmp_path / "v.json"), str(tmp_path / "b.json")]
    flags = ["--model", "tiny", "--num_classes", str(C), "--image_hw", *map(str, HW),
             "--max_rois", str(R), "--batch_size", "2", "--pyramid", "1.0", "1.25"]
    assert jcli.main(argv + [str(tmp_path / "j.json")] + flags) == 0
    assert tcli.main(argv + [str(tmp_path / "t.json")] + flags + ["--device", "cpu"]) == 0
    _compare_det_protos(proto_load(str(tmp_path / "t.json")), proto_load(str(tmp_path / "j.json")))
    # --weights loads a checkpoint into the tool's model (here its own weights)
    from vdetlib_tpu_torch.pipeline.checkpoint import save_params

    save_params(str(tmp_path / "det.pt"), tmodel)
    assert tcli.main(argv + [str(tmp_path / "t2.json")] + flags
                     + ["--weights", str(tmp_path / "det.pt"), "--device", "cpu"]) == 0
    assert proto_load(str(tmp_path / "t2.json")) == proto_load(str(tmp_path / "t.json"))


def test_track_tool_matches_jax_tool(trackers, tmp_path, monkeypatch):
    import vdetlib_tpu.cli.track as jcli
    import vdetlib_tpu_torch.cli.track as tcli
    import vdetlib_tpu_torch.weights as tweights

    jmodel, jparams, tmodel = trackers
    _, vid, det = _track_inputs(tmp_path, "ttool")
    proto_dump(vid, str(tmp_path / "v.json"))
    proto_dump(det, str(tmp_path / "d.json"))
    monkeypatch.setattr(jtrack, "init_tracker", lambda *a, **k: (jmodel, jparams))
    monkeypatch.setattr(tweights, "init_tracker", lambda *a, **k: tmodel)
    argv = [str(tmp_path / "v.json"), str(tmp_path / "d.json")]
    flags = ["--max_tracks", "6", "--anchors_per_round", "3"]
    assert jcli.main(argv + [str(tmp_path / "j.json")] + flags) == 0
    assert tcli.main(argv + [str(tmp_path / "t.json")] + flags + ["--device", "cpu"]) == 0
    _compare_track_protos(proto_load(str(tmp_path / "t.json")),
                          proto_load(str(tmp_path / "j.json")))
    # detection snapping through both tools
    snap = flags + ["--snap_weight", "0.5", "--snap_iou", "0.4"]
    assert jcli.main(argv + [str(tmp_path / "j2.json")] + snap) == 0
    assert tcli.main(argv + [str(tmp_path / "t2.json")] + snap + ["--device", "cpu"]) == 0
    _compare_track_protos(proto_load(str(tmp_path / "t2.json")),
                          proto_load(str(tmp_path / "j2.json")))
    # --weights loads a checkpoint into the tool's model (here its own weights)
    from vdetlib_tpu_torch.pipeline.checkpoint import save_params

    save_params(str(tmp_path / "trk.pt"), tmodel)
    assert tcli.main(argv + [str(tmp_path / "t3.json")] + flags
                     + ["--weights", str(tmp_path / "trk.pt"), "--device", "cpu"]) == 0
    assert proto_load(str(tmp_path / "t3.json")) == proto_load(str(tmp_path / "t.json"))
