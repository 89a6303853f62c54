"""Port parity and behaviour: the fused sweep (``pipeline/fused_runner.py``),
its config tree (``pipeline/runner.py``), the evaluation it feeds
(``evaluation/vid_map.py``, ``evaluation/calibration.py``) and the
``pipeline`` tool.

Two synthetic videos (JPEGs on disk, C=4, proposals around the objects with
a varying count per frame) through the float32 tiny nets of
``tests/torch_fused_common.py`` at 96×128: 6 frames stored at 96×128 and 8
frames stored at 192×256, which the loader resizes (proposals scaled down,
output boxes scaled back up to native pixels).

- Against JAX: ``run_videos_fused`` of both packages on the same videos and
  weights, compared by (frame, class) as ``tests/test_fused_runner.py``
  does: the same keys and entry counts, scores within 0.01, boxes within
  0.5 px (the cross-compilation bound of ``__graft_entry__.py``), and the
  same tubelet count. Both run at a bucket of 8 frames (the default 32
  makes the JAX program's CPU compile ~1.6× longer); the 6-frame video is
  still padded. Per the parity-test blind spots (CLAUDE.md) the fixture
  asserts that roi counts and slot layouts vary from frame to frame.
- The runner (port only, default bucket): resume writes nothing,
  ``keep_going`` over a video whose frames are missing, ``group_size`` 2
  equal to 1 byte for byte, in-memory frames equal to frames decoded from
  disk, byte for byte (the first video: in-memory frames are at
  ``image_hw`` with their proposals in those pixels).
- ``dump_config``: the tool's ``pipeline_config.json`` equals the JAX
  tool's for the same flags, key for key, except ``tracker_cfg.dtype``
  (the framework's dtype name).
- ``vid_map`` and ``rank_normalize`` equal the JAX functions to 1e-12.
- The ``pipeline`` tool with weights (``--engine fused --device cpu
  --eval``): its protos equal a direct ``run_videos_fused`` call byte for
  byte, and the printed mAP is ``vid_map`` of them; with detection
  snapping, EMA templates, tubelet boxes or the "accurate" flow (either
  engine) its final protos stay within the JAX bounds above against the
  JAX tool's, as with ``--multihost`` in one process; a video without
  proposals raises JAX's error.
"""

import contextlib
import functools
import io
import json
import os
import pathlib
import re

import numpy as np
import pytest
import torch

import vdetlib_tpu.pipeline.fused_runner as jfr
import vdetlib_tpu_torch.pipeline.fused_runner as tfr
from tests.torch_fused_common import HW, C, R, f32_nets
from vdetlib_tpu.cli import pipeline_tool as j_pipeline_tool
from vdetlib_tpu.data.synth import SynthConfig, annot_proto, make_video, write_frames
from vdetlib_tpu.evaluation.calibration import rank_normalize as j_rank_normalize
from vdetlib_tpu.evaluation.vid_map import vid_map as j_vid_map
from vdetlib_tpu.pipeline import runner as jrunner
from vdetlib_tpu.video import detect as jdetect
from vdetlib_tpu.video import link as jlink
from vdetlib_tpu.video import mgp as jmgp
from vdetlib_tpu.video import rescore as jrescore
from vdetlib_tpu.video import track as jtrack
from vdetlib_tpu_torch.cli import pipeline_tool
from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.evaluation.calibration import rank_normalize
from vdetlib_tpu_torch.evaluation.vid_map import vid_map
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
from vdetlib_tpu_torch.pipeline import runner as trunner
from vdetlib_tpu_torch.pipeline.checkpoint import load_params, save_params
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.video import detect as tdetect
from vdetlib_tpu_torch.video import link as tlink
from vdetlib_tpu_torch.video import mgp as tmgp
from vdetlib_tpu_torch.video import rescore as trescore
from vdetlib_tpu_torch.video import track as ttrack
from vdetlib_tpu_torch.weights import init_detector, init_tracker

torch.set_num_threads(2)

LENGTHS = (6, 8)
NATIVE_HW = (HW, (2 * HW[0], 2 * HW[1]))  # the frames' stored sizes
SMALL_BUCKET = 8
TOL_SCORE, TOL_BOX = 0.01, 0.5
# the tool's flags for both packages (the fused config of tests/test_torch_fused.py
# where the tool has a flag for it)
CLI_FLAGS = ["--model", "tiny", "--num_classes", str(C), "--image_hw", *map(str, HW),
             "--max_rois", str(R), "--batch_size", "4", "--max_tracks", "8",
             "--anchor_thresh", "0.26", "--boost", "mean", "--bg_decay", "0.7",
             "--track_stride", "1", "--stages", "detect,mgp,track,perturb,rescore,seq_nms"]


def _cfg(runner, detect, mgp, track, rescore, link, trk_cfg):
    """The fused config of tests/test_torch_fused.py as a PipelineConfig."""
    return runner.PipelineConfig(
        detect=detect.DetectOptions(batch_size=4, max_rois=R, image_hw=HW, score_thresh=0.2),
        mgp=mgp.MGPOptions(num_classes=C, max_boxes=24),
        track=track.TrackOptions(max_tracks=8, anchors_per_round=4, batch_size=4, image_hw=HW,
                                 anchor_thresh=0.26),
        tracker_cfg=trk_cfg,
        rescore=rescore.RescoreOptions(num_classes=C, max_boxes=24, max_tracks=8),
        link=link.LinkOptions(num_classes=C, max_boxes=24, max_paths=16),
    )


@pytest.fixture(scope="module")
def nets():
    return f32_nets()


@pytest.fixture(scope="module")
def tcfg(nets):
    return _cfg(trunner, tdetect, tmgp, ttrack, trescore, tlink, nets.ttrk_cfg)


@pytest.fixture(scope="module")
def models(nets):
    return trunner.Models(nets.tdet, nets.ttrk)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """gen_synth's layout: NAME.vid.json, NAME.box.json, NAME.annot.json."""
    root = tmp_path_factory.mktemp("sweep_data")
    rng = np.random.default_rng(0)
    inputs = []
    for i, (T, (h, w)) in enumerate(zip(LENGTHS, NATIVE_HW)):
        sv = make_video(SynthConfig(num_frames=T, height=h, width=w, num_classes=C,
                                    seed=11 + i), video=f"sweep{i}")
        vid = write_frames(sv, str(root / "frames"))
        boxes = []
        for t, f in enumerate(vid["frames"]):
            # proposals around the objects plus clutter, a varying count per frame
            k = rng.integers(0, sv.gt_boxes.shape[0], R)
            jit = rng.normal(0, 4, (R, 4))
            for r in range(R - int(rng.integers(0, 6))):
                b = np.clip(sv.gt_boxes[k[r], t] + jit[r], 0, [w - 1, h - 1] * 2)
                boxes.append({"frame": int(f["frame"]), "bbox": [float(v) for v in b]})
        box = {"video": sv.video, "boxes": boxes}
        proto_dump(vid, str(root / f"{sv.video}.vid.json"))
        proto_dump(box, str(root / f"{sv.video}.box.json"))
        proto_dump(annot_proto(sv), str(root / f"{sv.video}.annot.json"))
        inputs.append((vid, box))
    return root, inputs


@pytest.fixture(scope="module")
def sweeps(nets, tcfg, models, dataset, tmp_path_factory):
    """JAX and port ``run_videos_fused`` at a bucket of 8 frames."""
    _, inputs = dataset
    work = tmp_path_factory.mktemp("sweeps")
    jcfg = _cfg(jrunner, jdetect, jmgp, jtrack, jrescore, jlink, nets.jtrk_cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfr, "FusedEngine", functools.partial(jfr.FusedEngine, bucket=SMALL_BUCKET))
        mp.setattr(tfr, "FusedEngine", functools.partial(tfr.FusedEngine, bucket=SMALL_BUCKET))
        want = jfr.run_videos_fused(str(work / "jax"), inputs,
                                    jrunner.Models(nets.jdet, nets.jdp, nets.jtrk, nets.jtp), jcfg)
        got = tfr.run_videos_fused(str(work / "torch"), inputs, models, tcfg)
    return want, got


@pytest.fixture(scope="module")
def g1(tcfg, models, dataset, tmp_path_factory):
    """The port's sweep at its defaults (bucket 32, group 1)."""
    work = str(tmp_path_factory.mktemp("g1"))
    return tfr.run_videos_fused(work, dataset[1], models, tcfg)


def _index_dets(proto):
    idx = {}
    for d in proto["detections"]:
        for sc in d["scores"]:
            idx.setdefault((d["frame"], sc["class_index"]), []).append(
                (sc["score"], tuple(d["bbox"])))
    for v in idx.values():
        v.sort()
    return idx


def _bytes(result):
    return {k: pathlib.Path(result[k]).read_bytes() for k in ("final", "tubelets")}


def test_sweep_matches_jax(dataset, sweeps):
    _, inputs = dataset
    want, got = sweeps
    roi_counts = [sum(b["frame"] == f["frame"] for b in box["boxes"])
                  for vid, box in inputs for f in vid["frames"]]
    assert len(set(roi_counts)) > 1, "roi counts do not vary"
    assert len(want) == len(got) == len(inputs)
    for pw, pg in zip(want, got):
        assert not pw.get("error") and not pg.get("error")
        want_proto = proto_load(pw["final"])
        layouts = {}  # frame -> the classes of each detection, in slot order
        for d in want_proto["detections"]:
            cls = tuple(s["class_index"] for s in d["scores"])
            layouts[d["frame"]] = layouts.get(d["frame"], ()) + (cls,)
        assert len(set(layouts.values())) > 1, "slot layout is constant"
        assert len({len(v) for v in layouts.values()}) > 1, "detection counts are constant"
        a, b = _index_dets(want_proto), _index_dets(proto_load(pg["final"]))
        assert set(a) == set(b)
        n = 0
        for key in a:
            assert len(a[key]) == len(b[key]), key
            for (sa, ba), (sb, bb) in zip(a[key], b[key]):
                assert abs(sa - sb) <= TOL_SCORE, (key, sa, sb)
                np.testing.assert_allclose(bb, ba, atol=TOL_BOX, rtol=0, err_msg=str(key))
                n += 1
        assert n > 0
        tw, tg = proto_load(pw["tubelets"]), proto_load(pg["tubelets"])
        assert len(tw["tracks"]) == len(tg["tracks"]) > 0


def test_resume_writes_nothing(tcfg, models, dataset, g1):
    before = {r[k]: os.stat(r[k]).st_mtime_ns for r in g1 for k in ("final", "tubelets")}
    again = tfr.run_videos_fused(os.path.dirname(os.path.dirname(g1[0]["final"])), dataset[1],
                                 models, tcfg)
    assert [r["final"] for r in again] == [r["final"] for r in g1]
    assert not any(r.get("error") for r in again)
    after = {r[k]: os.stat(r[k]).st_mtime_ns for r in again for k in ("final", "tubelets")}
    assert after == before


def _broken_video(vid_proto, name):
    """A vid_proto whose frame files do not exist (decoding fails at load)."""
    return dict(vid_proto, video=name,
                frames=[dict(f, path="missing/" + f["path"]) for f in vid_proto["frames"]])


def test_keep_going_skips_a_bad_video(tcfg, models, dataset, g1, tmp_path):
    _, inputs = dataset
    bad = (_broken_video(inputs[0][0], "sweepbad"), inputs[0][1])
    sweep = [bad] + list(inputs)
    with pytest.raises(FileNotFoundError):
        tfr.run_videos_fused(str(tmp_path / "strict"), sweep, models, tcfg)
    results = tfr.run_videos_fused(str(tmp_path / "kg"), sweep, models, tcfg, keep_going=True)
    assert "FileNotFoundError" in results[0]["error"]
    assert not os.path.exists(results[0]["final"])
    for r, r1 in zip(results[1:], g1):
        assert not r.get("error")
        assert _bytes(r) == _bytes(r1)


def test_group_size_2_equals_group_size_1(tcfg, models, dataset, g1, tmp_path):
    g2 = tfr.run_videos_fused(str(tmp_path / "g2"), dataset[1], models, tcfg, group_size=2)
    for r2, r1 in zip(g2, g1):
        assert _bytes(r2) == _bytes(r1)


def test_in_memory_frames_equal_frames_from_disk(tcfg, models, dataset, g1, tmp_path):
    vid, box = dataset[1][0]  # stored at image_hw
    loader = FrameLoader(vid, target_hw=HW)
    frames = np.stack([img for _, img, _ in loader.iter_frames()])
    loader.close()
    mem = tfr.run_videos_fused(str(tmp_path / "mem"), [(vid, box, frames)], models, tcfg)
    assert _bytes(mem[0]) == _bytes(g1[0])


def test_vid_map_and_rank_normalize_match_jax(dataset, sweeps):
    root, inputs = dataset
    pairs = [(proto_load(r["final"]), proto_load(str(root / f"{vid['video']}.annot.json")))
             for r, (vid, _) in zip(sweeps[1], inputs)]
    m, aps = vid_map(pairs)
    jm, japs = j_vid_map(pairs)
    assert m > 0 and sorted(aps) == sorted(japs)
    assert abs(m - jm) <= 1e-12
    for ci in aps:
        assert abs(aps[ci] - japs[ci]) <= 1e-12
    for dp, _ in pairs:
        for blend in (0.0, 0.3):
            got, want = rank_normalize(dp, blend), j_rank_normalize(dp, blend)
            assert len(got["detections"]) == len(want["detections"]) > 0
            for a, b in zip(got["detections"], want["detections"]):
                assert {k: v for k, v in a.items() if k != "scores"} == \
                       {k: v for k, v in b.items() if k != "scores"}
                for sa, sb in zip(a["scores"], b["scores"]):
                    assert sa["class_index"] == sb["class_index"]
                    assert abs(sa["score"] - sb["score"]) <= 1e-12


@pytest.fixture(scope="module")
def cli_run(nets, dataset, tmp_path_factory):
    """The port's tool with both checkpoints, --engine fused --device cpu --eval."""
    root, _ = dataset
    tmp = tmp_path_factory.mktemp("cli")
    det_ckpt, trk_ckpt = str(tmp / "det.pt"), str(tmp / "trk.pt")
    save_params(det_ckpt, nets.tdet)
    save_params(trk_ckpt, nets.ttrk)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pipeline_tool.main([str(root), str(tmp / "work"), *CLI_FLAGS, "--engine", "fused",
                                 "--device", "cpu", "--eval", "--detector_weights", det_ckpt,
                                 "--tracker_weights", trk_ckpt])
    return tmp, rc, out.getvalue()


def test_pipeline_tool_matches_direct_sweep(dataset, cli_run):
    """The tool's config replicated by hand (its dump equals the tool's), the
    checkpoints loaded into the tool's models, then ``run_videos_fused``."""
    from vdetlib_tpu_torch.video.perturb import PerturbOptions

    root, inputs = dataset
    tmp, rc, printed = cli_run
    assert rc == 0
    det = load_params(str(tmp / "det.pt"), init_detector(detector_preset("tiny", num_classes=C),
                                                         device="cpu"))
    trk_cfg = TrackerConfig()
    trk = load_params(str(tmp / "trk.pt"), init_tracker(trk_cfg, device="cpu"))
    cfg = trunner.PipelineConfig(
        detect=tdetect.DetectOptions(batch_size=4, max_rois=R, image_hw=HW, score_thresh=0.05),
        mgp=tmgp.MGPOptions(num_classes=C, image_hw=HW),
        track=ttrack.TrackOptions(max_tracks=8, image_hw=HW, anchor_thresh=0.26,
                                  frame_stride=1),
        tracker_cfg=trk_cfg,
        rescore=trescore.RescoreOptions(num_classes=C, boost="mean", bg_decay=0.7),
        link=tlink.LinkOptions(num_classes=C),
        perturb=PerturbOptions(),
        stages=("detect", "mgp", "track", "perturb", "rescore", "seq_nms"),
    )
    direct = tfr.run_videos_fused(str(tmp / "direct"), inputs, trunner.Models(det, trk), cfg)
    assert json.loads((tmp / "direct" / "pipeline_config.json").read_text()) == \
           json.loads((tmp / "work" / "pipeline_config.json").read_text())
    pairs = []
    for r, (vid, _) in zip(direct, inputs):
        tool = tmp / "work" / vid["video"]
        assert _bytes({k: tool / f"{k}.json" for k in ("final", "tubelets")}) == _bytes(r)
        pairs.append((proto_load(r["final"]),
                      proto_load(str(root / f"{vid['video']}.annot.json"))))
    m, _ = vid_map(pairs)
    assert re.search(r"^mAP = ([0-9.]+) over 2 videos$", printed, re.M).group(1) == f"{m:.4f}"


def test_pipeline_config_matches_jax_tool(dataset, cli_run, tmp_path, monkeypatch):
    """The JAX tool with the same flags, its sweep replaced by ``dump_config``."""
    root, _ = dataset
    tmp, _, _ = cli_run

    def dump_only(workdir, inputs, models, cfg, **kw):
        jrunner.dump_config(workdir, cfg)
        return []

    monkeypatch.setattr(jfr, "run_videos_fused", dump_only)
    assert j_pipeline_tool.main([str(root), str(tmp_path), *CLI_FLAGS, "--engine", "fused"]) == 0
    want = json.loads((tmp_path / "pipeline_config.json").read_text())
    got = json.loads((tmp / "work" / "pipeline_config.json").read_text())
    # the one key whose value names the framework's dtype
    assert got["tracker_cfg"].pop("dtype") == "torch.bfloat16"
    assert "bfloat16" in want["tracker_cfg"].pop("dtype")
    assert got == want


def test_fused_engine_without_proposals_names_the_staged_engine(models, tcfg, dataset):
    """A video without a box_proto: the ValueError of JAX's
    ``FusedEngine.load`` (``vdetlib_tpu/pipeline/fused_runner.py``), word
    for word."""
    _, inputs = dataset
    vid = inputs[0][0]
    with pytest.raises(ValueError) as got:
        tfr.FusedEngine(models, tcfg).load(vid, None)
    assert str(got.value) == (f"{vid['video']}: fused engine needs proposals (box_proto); "
                              f"run the staged engine for proposal-free flows")


@pytest.mark.parametrize("flags", [
    ["--engine", "fused", "--snap_weight", "0.5"],
    ["--engine", "fused", "--tubelet_boxes"],
    ["--engine", "fused", "--template_eta", "0.1"],
    ["--snap_weight", "0.5"],
    ["--template_eta", "0.1"],
    ["--flow_preset", "accurate"],
    # one process without torch's or JAX's multi-process environment: each
    # tool sweeps every video (the two-process run: test_torch_multihost.py)
    ["--engine", "fused", "--multihost"],
], ids=["snap_weight", "tubelet_boxes", "template_eta", "staged_snap_weight",
        "staged_template_eta", "staged_flow_preset_accurate", "multihost"])
def test_pipeline_tool_options_match_jax_tool(nets, dataset, tmp_path, monkeypatch, flags):
    """The options the port's tool once refused, through both tools with the
    same float32 weights: each video's ``final.json`` within the bounds of
    ``test_sweep_matches_jax``, the same tubelet count (the fused engine at
    a bucket of 8 frames in both packages, as there)."""
    import vdetlib_tpu.nn.detector as jdetector
    import vdetlib_tpu_torch.weights as tweights

    root, inputs = dataset
    mp = monkeypatch
    mp.setattr(jfr, "FusedEngine", functools.partial(jfr.FusedEngine, bucket=SMALL_BUCKET))
    mp.setattr(tfr, "FusedEngine", functools.partial(tfr.FusedEngine, bucket=SMALL_BUCKET))
    mp.setattr(jdetector, "init_detector", lambda *a, **kw: (nets.jdet, nets.jdp))
    mp.setattr(jtrack, "init_tracker", lambda *a, **kw: (nets.jtrk, nets.jtp))
    mp.setattr(tweights, "init_detector", lambda *a, **kw: nets.tdet)
    mp.setattr(tweights, "init_tracker", lambda *a, **kw: nets.ttrk)
    with contextlib.redirect_stdout(io.StringIO()):
        assert j_pipeline_tool.main([str(root), str(tmp_path / "j"), *CLI_FLAGS, *flags]) == 0
        assert pipeline_tool.main([str(root), str(tmp_path / "t"), *CLI_FLAGS, *flags,
                                   "--device", "cpu"]) == 0
    for vid, _ in inputs:
        want = proto_load(str(tmp_path / "j" / vid["video"] / "final.json"))
        got = proto_load(str(tmp_path / "t" / vid["video"] / "final.json"))
        a, b = _index_dets(want), _index_dets(got)
        assert set(a) == set(b) and len(a) > 0
        for key in a:
            assert len(a[key]) == len(b[key]), key
            for (sa, ba), (sb, bb) in zip(a[key], b[key]):
                assert abs(sa - sb) <= TOL_SCORE, (key, sa, sb)
                np.testing.assert_allclose(bb, ba, atol=TOL_BOX, rtol=0, err_msg=str(key))
        tw, tg = (proto_load(str(tmp_path / s / vid["video"] / "tubelets.json")) for s in "jt")
        assert len(tw["tracks"]) == len(tg["tracks"]) > 0
