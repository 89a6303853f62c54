"""The port's copies of the JAX package's host modules behave the same.

- ``data.synth``: ``make_video`` is bit-identical (frames, boxes, classes)
  for several seeded configurations of both tiers (the hard tier's
  visibility, occlusion and distractor arrays too), and so are
  ``box_proto``, ``det_proto_from_gt`` and ``vid_proto_in_memory``;
- ``protos``: the array bridges give equal arrays and protos, the codec
  round-trips protos written by either package (plain and gzip), and the
  accessors agree;
- ``data.loader``: decoded frames and scales are identical;
- ``utils.log``: ``StageMetrics`` records the same counters.
Tolerance: none (exact equality everywhere).
"""

import numpy as np
import pytest

from vdetlib_tpu import protos as jprotos
from vdetlib_tpu.data import loader as jloader
from vdetlib_tpu.data import synth as jsynth
from vdetlib_tpu_torch import protos as tprotos
from vdetlib_tpu_torch.data import loader as tloader
from vdetlib_tpu_torch.data import synth as tsynth
from vdetlib_tpu_torch.protos import accessors as tacc
from vdetlib_tpu_torch.utils.log import StageMetrics

CONFIGS = [
    dict(num_frames=6, seed=0),
    dict(num_frames=5, height=96, width=128, num_classes=31, seed=7, max_speed=2.0),
    dict(num_frames=4, height=120, width=160, seed=3, scale_rate=0.03, num_objects=5),
    dict(num_frames=4, seed=11, class_coded_appearance=True, proposals_per_frame=40),
]


def _pair(kw, video="v"):
    return (jsynth.make_video(jsynth.SynthConfig(**kw), video=video),
            tsynth.make_video(tsynth.SynthConfig(**kw), video=video))


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_make_video_and_its_protos_are_bit_identical(kw):
    j, t = _pair(kw)
    np.testing.assert_array_equal(t.frames, j.frames)
    np.testing.assert_array_equal(t.gt_boxes, j.gt_boxes)
    np.testing.assert_array_equal(t.gt_classes, j.gt_classes)
    assert t.frame_ids == j.frame_ids
    assert tsynth.box_proto(t) == jsynth.box_proto(j)
    assert tsynth.det_proto_from_gt(t) == jsynth.det_proto_from_gt(j)
    assert tsynth.det_proto_from_gt(t, drop_rate=0.2, dropout_windows=1) == \
        jsynth.det_proto_from_gt(j, drop_rate=0.2, dropout_windows=1)
    assert tsynth.vid_proto_in_memory(t) == jsynth.vid_proto_in_memory(j)


HARD_CONFIGS = [
    dict(num_frames=8, height=96, width=128, seed=11),
    dict(num_frames=6, height=96, width=128, seed=2, num_occluders=0, appearance_drift=0.6,
         class_coded_appearance=False, min_size=20, max_size=40),
    dict(num_frames=5, seed=4, num_classes=31, crossing_paths=False, camera_jitter=0.0,
         num_distractors=5, distractor_on=(1, 3), scale_rate=0.02),
]


@pytest.mark.parametrize("kw", HARD_CONFIGS, ids=range(len(HARD_CONFIGS)))
def test_hard_tier_is_byte_identical(kw):
    """The hard tier (``hard_config``): frames, boxes, visibility, occlusion
    and the distractor arrays byte for byte, and the protos derived from it."""
    j = jsynth.make_video(jsynth.hard_config(**kw), video="h")
    t = tsynth.make_video(tsynth.hard_config(**kw), video="h")
    assert t.config.is_hard and j.config.is_hard
    for name in ("frames", "gt_boxes", "gt_classes", "gt_visible", "gt_occluded",
                 "distractor_boxes", "distractor_on", "distractor_classes"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert not t.gt_visible.all() or t.gt_occluded.max() > 0  # the tier's effects show
    assert tsynth.box_proto(t) == jsynth.box_proto(j)
    assert tsynth.det_proto_from_gt(t) == jsynth.det_proto_from_gt(j)


def test_array_bridges_and_accessors_agree():
    j, t = _pair(CONFIGS[1])
    det, box, vid = jsynth.det_proto_from_gt(j), jsynth.box_proto(j), jsynth.vid_proto_in_memory(j)
    fids = j.frame_ids
    for a, b in zip(tprotos.det_proto_to_arrays(det, fids, 16, 31),
                    jprotos.det_proto_to_arrays(det, fids, 16, 31)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tprotos.box_proto_to_arrays(box, fids, 12),
                    jprotos.box_proto_to_arrays(box, fids, 12)):
        np.testing.assert_array_equal(a, b)
    boxes, scores, mask = jprotos.det_proto_to_arrays(det, fids, 16, 31)
    mask[:, ::3] = False  # a varying slot layout
    for kw in (dict(), dict(score_thresh=0.5), dict(class_names=[f"c{i}" for i in range(31)])):
        assert tprotos.arrays_to_det_proto(boxes, scores, mask, fids, "v", **kw) == \
            jprotos.arrays_to_det_proto(boxes, scores, mask, fids, "v", **kw)
    assert tacc.frame_ids(vid) == jprotos.frame_ids(vid)
    assert tacc.frame_path_at(vid, fids[2]) == jprotos.frame_path_at(vid, fids[2])
    from vdetlib_tpu.protos.accessors import det_class_indices
    assert tacc.det_class_indices(det) == det_class_indices(det)


@pytest.mark.parametrize("name", ["det.json", "det.json.gz"])
def test_codec_round_trips_between_packages(tmp_path, name):
    j, _ = _pair(CONFIGS[0])
    det = jsynth.det_proto_from_gt(j)
    det["detections"][0]["scores"][0]["score"] = np.float32(0.5)  # a numpy scalar leaks in
    tprotos.proto_dump(det, str(tmp_path / f"t_{name}"))
    jprotos.proto_dump(det, str(tmp_path / f"j_{name}"))
    assert tprotos.proto_exists(str(tmp_path / f"t_{name}"))
    for path in (tmp_path / f"t_{name}", tmp_path / f"j_{name}"):
        assert tprotos.proto_load(str(path)) == jprotos.proto_load(str(path))
    assert tprotos.proto_load(str(tmp_path / f"t_{name}")) == \
        jprotos.proto_load(str(tmp_path / f"j_{name}"))


def test_loader_and_write_frames_agree(tmp_path):
    j, t = _pair(dict(num_frames=3, height=96, width=128, seed=5), video="clip")
    vid_t = tsynth.write_frames(t, str(tmp_path / "t"))
    vid_j = jsynth.write_frames(j, str(tmp_path / "j"))
    assert [f["path"] for f in vid_t["frames"]] == [f["path"] for f in vid_j["frames"]]
    for hw in (None, (48, 64), (120, 160)):
        lt = tloader.FrameLoader(vid_t, target_hw=hw, num_threads=2)
        lj = jloader.FrameLoader(vid_j, target_hw=hw, num_threads=2)
        assert len(lt) == len(lj) == 3
        for (ft, it, st), (fj, ij, sj) in zip(lt.iter_frames(), lj.iter_frames()):
            assert ft == fj and st == sj
            np.testing.assert_array_equal(it, ij)
        lt.close()
        lj.close()
    with pytest.raises(FileNotFoundError):
        tloader.load_frame(str(tmp_path / "missing.jpg"))


def test_stage_metrics_record(tmp_path):
    sink = tmp_path / "m.jsonl"
    m = StageMetrics("s", jsonl_path=str(sink))
    m.add("dets", 2)
    m.add("dets")
    m.set("frames", 10)
    rec = m.finish()
    assert rec["stage"] == "s" and rec["dets"] == 3.0 and rec["frames"] == 10
    assert rec["frames_per_sec"] > 0 and sink.read_text().count("\n") == 1
