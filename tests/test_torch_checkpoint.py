"""Checkpoints of the port (``pipeline/checkpoint.py``), the Orbax converter
(``scripts/convert_orbax_checkpoint.py``) and the weight flags of the
``detect``, ``track`` and ``stream`` tools.

- Round trip: save then load gives every tensor equal, bit for bit; a
  missing key, an extra key or a wrong shape raises and names the key; an
  Orbax directory raises and names the converter.
- Converter: a tiny JAX detector (bf16, as the JAX package initialises it)
  and the default tracker, saved by ``vdetlib_tpu.pipeline.checkpoint.save_params``
  and converted through the script's ``main``, load into state_dicts equal
  bit for bit to ``detector_state_from_flax`` / ``tracker_state_from_flax``
  of the same trees, and the converted detector's outputs agree with the
  JAX detector's within tests/test_torch_detector.py's bf16 bounds (probs
  1e-2, boxes 0.5 px).
- Tool flags: each tool with a checkpoint gives the same protos as the same
  module loaded in Python (``detect``: ``det_vid``; ``track``:
  ``track_from_det``; ``stream``: the tool run with the seeds whose random
  weights the checkpoint holds). The checkpoints hold weights other than the
  tools' seed-0 ones, so a flag that loaded nothing would fail.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu.nn.detector import init_detector as j_init_detector
from vdetlib_tpu.nn.presets import detector_preset as j_detector_preset
from vdetlib_tpu.nn.tracker_net import TrackerConfig as JTrackerConfig
from vdetlib_tpu.pipeline.checkpoint import save_params as orbax_save
from vdetlib_tpu.video.detect import _detect_step as j_detect_step
from vdetlib_tpu.video.track import init_tracker as j_init_tracker
from vdetlib_tpu_torch.cli import detect as detect_tool
from vdetlib_tpu_torch.cli import stream as stream_tool
from vdetlib_tpu_torch.cli import track as track_tool
from vdetlib_tpu_torch.data.synth import box_proto, det_proto_from_gt, write_frames
from vdetlib_tpu_torch.nn.detector import Detector
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet
from vdetlib_tpu_torch.pipeline.checkpoint import FORMAT, load_params, save_params
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.video.detect import DetectOptions, _detect_step, det_vid
from vdetlib_tpu_torch.video.track import TrackOptions, track_from_det
from vdetlib_tpu_torch.weights import (
    detector_state_from_flax,
    init_detector,
    init_tracker,
    tracker_state_from_flax,
)

torch.set_num_threads(2)

HW = (96, 128)
C, R = 4, 16
SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "convert_orbax_checkpoint.py"


def _tiny(seed, num_classes=C):
    return init_detector(detector_preset("tiny", num_classes=num_classes),
                         torch.Generator().manual_seed(seed), device="cpu")


def _assert_same_tensors(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_save_load_round_trip(tmp_path):
    model = _tiny(3)
    path = str(tmp_path / "det.pt")
    save_params(path, model)
    assert sorted(os.listdir(tmp_path)) == ["det.pt"]  # no temporary left behind
    fresh = _tiny(4)
    assert not all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                     model.state_dict().values()))
    assert load_params(path, fresh) is fresh
    _assert_same_tensors(fresh.state_dict(), model.state_dict())
    _assert_same_tensors(load_params(path), model.state_dict())
    blob = torch.load(path, weights_only=True)
    assert blob["format"] == FORMAT
    assert all(v.device.type == "cpu" for v in blob["state_dict"].values())
    # a state_dict saves the same way
    save_params(str(tmp_path / "sd.pt"), model.state_dict())
    _assert_same_tensors(load_params(str(tmp_path / "sd.pt")), model.state_dict())


def _missing(sd):
    sd.pop("head.cls.bias")
    return sd


def _extra(sd):
    sd["head.extra.weight"] = torch.zeros(2)
    return sd


def _reshaped(sd):
    sd["head.cls.weight"] = sd["head.cls.weight"][:-1]
    return sd


@pytest.mark.parametrize("edit, key", [(_missing, "head.cls.bias"), (_extra, "head.extra.weight"),
                                       (_reshaped, "head.cls.weight")],
                         ids=["missing", "extra", "shape"])
def test_load_names_the_key_that_does_not_fit(tmp_path, edit, key):
    path = str(tmp_path / "bad.pt")
    save_params(path, edit(_tiny(3).state_dict()))
    model = _tiny(4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        load_params(path, model)
    _assert_same_tensors(model.state_dict(), before)  # nothing loaded


def test_load_refuses_an_orbax_directory_and_names_the_converter(tmp_path):
    _, params = j_init_tracker(JTrackerConfig(), image_hw=HW, seed=0)
    orbax_save(str(tmp_path / "orbax"), params)
    with pytest.raises(ValueError, match="convert_orbax_checkpoint.py"):
        load_params(str(tmp_path / "orbax"), TrackerNet(TrackerConfig()))


def test_load_refuses_a_file_of_another_format(tmp_path):
    path = str(tmp_path / "raw.pt")
    torch.save(_tiny(3).state_dict(), path)
    with pytest.raises(ValueError, match="not a vdetlib_tpu_torch.params/1 checkpoint"):
        load_params(path)


@pytest.fixture(scope="module")
def converter():
    spec = importlib.util.spec_from_file_location("convert_orbax_checkpoint", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def orbax_checkpoints(tmp_path_factory):
    """A tiny JAX detector and the default tracker, as the JAX package
    initialises and saves them."""
    tmp = tmp_path_factory.mktemp("orbax")
    jdet, jdp = j_init_detector(j_detector_preset("tiny", num_classes=C), HW, max_rois=R, seed=0)
    jdp = jax.tree.map(np.asarray, jdp)
    # a trained regressor's delta scale (see tests/test_torch_detector.py)
    jdp["params"]["head"]["bbox"]["kernel"] = jdp["params"]["head"]["bbox"]["kernel"] * 0.1
    _, jtp = j_init_tracker(JTrackerConfig(), image_hw=HW, seed=0)
    orbax_save(str(tmp / "det"), jdp)
    orbax_save(str(tmp / "trk"), jtp)
    return tmp, jdet, jdp, jtp


@pytest.mark.parametrize("kind", ["detector", "tracker"])
def test_converter_gives_the_flax_state_bit_for_bit(converter, orbax_checkpoints, kind):
    tmp, _, jdp, jtp = orbax_checkpoints
    src = str(tmp / ("det" if kind == "detector" else "trk"))
    out = str(tmp / f"{kind}.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        assert converter.main([kind, src, out]) == 0
    if kind == "detector":
        want = detector_state_from_flax(jax.tree.map(np.asarray, jdp))
        model = Detector(detector_preset("tiny", num_classes=C))
    else:
        want = tracker_state_from_flax(jax.tree.map(np.asarray, jtp))
        model = TrackerNet(TrackerConfig())
    _assert_same_tensors(load_params(out), want)
    _assert_same_tensors(load_params(out, model).state_dict(), want)


def test_converted_detector_matches_jax(converter, orbax_checkpoints):
    tmp, jdet, jdp, _ = orbax_checkpoints
    out = str(tmp / "det_for_outputs.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        converter.main(["detector", str(tmp / "det"), out])
    model = load_params(out, Detector(detector_preset("tiny", num_classes=C)).eval())
    sv = make_video(SynthConfig(num_frames=4, height=HW[0], width=HW[1], num_classes=C, seed=0))
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, [HW[1] - 40, HW[0] - 40], (4, R, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (4, R, 2))], -1).astype(np.float32)
    jp, jb = j_detect_step(jdet, jdp, jnp.asarray(sv.frames), jnp.asarray(rois), True)
    with torch.no_grad():
        tp, tb = _detect_step(model, torch.from_numpy(sv.frames), torch.from_numpy(rois), True)
    assert np.abs(tp.numpy() - np.asarray(jp)).max() < 1e-2
    assert np.abs(tb.numpy() - np.asarray(jb)).max() < 0.5


def test_converter_refuses_a_path_that_is_not_a_directory(converter, tmp_path):
    with pytest.raises(SystemExit, match="not an Orbax checkpoint directory"):
        converter.main(["tracker", str(tmp_path / "nothing"), str(tmp_path / "out.pt")])


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An 8-frame video on disk with its proposals and a det_proto."""
    tmp = tmp_path_factory.mktemp("clip")
    from vdetlib_tpu_torch.data.synth import SynthConfig as TSynthConfig
    from vdetlib_tpu_torch.data.synth import make_video as t_make_video

    sv = t_make_video(TSynthConfig(num_frames=8, height=HW[0], width=HW[1], seed=2,
                                   proposals_per_frame=R), video="clip")
    vid_path, box_path, det_path = (str(tmp / f"clip.{k}.json") for k in ("vid", "box", "det"))
    proto_dump(write_frames(sv, str(tmp / "frames")), vid_path)
    proto_dump(box_proto(sv), box_path)
    proto_dump(det_proto_from_gt(sv), det_path)
    return tmp, vid_path, box_path, det_path


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        assert fn(argv) == 0


def test_detect_tool_loads_weights(clip, tmp_path):
    _, vid_path, box_path, _ = clip
    model = _tiny(7)
    save_params(str(tmp_path / "det.pt"), model)
    out = str(tmp_path / "det.json")
    _quiet(detect_tool.main, [vid_path, box_path, out, "--weights", str(tmp_path / "det.pt"),
                              "--model", "tiny", "--num_classes", str(C),
                              "--image_hw", *map(str, HW), "--max_rois", str(R),
                              "--device", "cpu"])
    want = det_vid(load_params(str(tmp_path / "det.pt"), _tiny(0)), proto_load(vid_path),
                   proto_load(box_path), DetectOptions(max_rois=R, image_hw=HW))
    assert proto_load(out) == json.loads(json.dumps(want))


def test_track_tool_loads_weights(clip, tmp_path):
    _, vid_path, _, det_path = clip
    cfg = TrackerConfig()
    model = init_tracker(cfg, torch.Generator().manual_seed(7), device="cpu")
    save_params(str(tmp_path / "trk.pt"), model)
    out = str(tmp_path / "track.json")
    _quiet(track_tool.main, [vid_path, det_path, out, "--weights", str(tmp_path / "trk.pt"),
                             "--anchor_thresh", "0.2", "--device", "cpu"])
    fresh = load_params(str(tmp_path / "trk.pt"), init_tracker(cfg, device="cpu"))
    want = track_from_det(fresh, proto_load(vid_path), proto_load(det_path), cfg,
                          TrackOptions(anchor_thresh=0.2))
    assert len(want["tracks"]) > 0
    assert proto_load(out) == json.loads(json.dumps(want))


def test_stream_tool_loads_weights(clip, tmp_path):
    """The tool draws the detector from --seed and the tracker from --seed + 1."""
    _, vid_path, _, _ = clip
    det = _tiny(7)
    trk = init_tracker(TrackerConfig(), torch.Generator().manual_seed(8), device="cpu")
    save_params(str(tmp_path / "det.pt"), det)
    save_params(str(tmp_path / "trk.pt"), trk)
    common = [vid_path, "--model", "tiny", "--num_classes", str(C), "--image_hw", *map(str, HW),
              "--max_rois", str(R), "--chunk", "4", "--seed_thresh", "0.2", "--device", "cpu"]
    _quiet(stream_tool.main, [*common[:1], str(tmp_path / "loaded"), *common[1:],
                              "--detector_weights", str(tmp_path / "det.pt"),
                              "--tracker_weights", str(tmp_path / "trk.pt")])
    _quiet(stream_tool.main, [*common[:1], str(tmp_path / "seeded"), *common[1:],
                              "--seed", "7"])
    _quiet(stream_tool.main, [*common[:1], str(tmp_path / "seed0"), *common[1:]])
    for name in ("final.json", "tubelets.json", "track.json"):
        loaded = proto_load(str(tmp_path / "loaded" / "clip" / name))
        assert loaded == proto_load(str(tmp_path / "seeded" / "clip" / name)), name
    assert proto_load(str(tmp_path / "loaded" / "clip" / "final.json")) != \
           proto_load(str(tmp_path / "seed0" / "clip" / "final.json"))
