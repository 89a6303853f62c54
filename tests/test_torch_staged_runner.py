"""Port parity and behaviour: the staged runner (``pipeline/runner.py``:
``load_frames_device``, ``run_video``, ``failed_paths``, ``run_videos``)
and ``pipeline --engine staged``, the tool's default.

The weights are the float32 tiny nets of ``tests/torch_fused_common.py``
(C=4, 96×128), the same in both packages. Tolerances:

- **Against JAX** (the runner and the tool on the same JPEG videos): every
  det_proto stage file (``detect``, ``mgp``, ``rescored``, ``final``) has
  the same (frame, class) keys with the same entry counts, scores within
  0.01 and boxes within 0.5 px (the cross-compilation bound of
  ``__graft_entry__.py``, as ``test_sweep_matches_jax`` in
  ``tests/test_torch_fused_runner.py``); every track_proto stage file
  (``track``, ``perturbed``, ``tubelets``) the same track count, each
  track on the same frames with boxes within 0.5 px. The mAP of GT
  detections through the chain is within 0.01 of JAX's.
- **The runner's own behaviour** (port only): byte for byte. A resumed
  run writes nothing (``st_mtime_ns``); deleting ``final.json`` and
  ``tubelets.json`` reruns seq-NMS alone; ``workers`` 2, the prefetch
  thread and in-memory frames each equal the plain run.
- **Staged vs fused in the port**, case for case as
  ``tests/test_fused_parity.py`` (its matched configuration, its video and
  proposals, its bounds): scores within rtol 1e-4 and atol 1e-5, boxes
  within rtol 1e-4 and atol 1e-3, the same keys, counts and track count,
  also with detection snapping, EMA templates, the "accurate" flow pyramid
  and tubelet boxes. In the tubelet-box cases the staged chain's rescoring
  and linking are also held, under the same bounds, against JAX's staged
  chain resumed from the port's ``detect``, ``mgp`` and ``track`` files
  (JAX's own test holds that chain equal to JAX's fused pipeline).
  Compared from the start, the two frameworks' "fast" flows differ by up
  to 0.18 px after two MGP hops on the varying-layout fixture, and one
  dedup decision near the NMS threshold flips.
- The options the staged engine once refused (snapping, EMA templates, the
  "accurate" flow) through ``run_videos`` against JAX's, every stage file
  within the JAX bounds above.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import shutil
from collections import defaultdict

import numpy as np
import pytest
import torch

import vdetlib_tpu.pipeline.runner as jrunner
from tests.torch_fused_common import HW, C, R, f32_nets
from vdetlib_tpu.cli import pipeline_tool as j_pipeline_tool
from vdetlib_tpu.data.synth import annot_proto
from vdetlib_tpu.video import detect as jdetect
from vdetlib_tpu.video import link as jlink
from vdetlib_tpu.video import mgp as jmgp
from vdetlib_tpu.video import perturb as jperturb
from vdetlib_tpu.video import rescore as jrescore
from vdetlib_tpu.video import track as jtrack
from vdetlib_tpu_torch.cli import pipeline_tool
from vdetlib_tpu_torch.data.loader import FrameLoader
from vdetlib_tpu_torch.data.synth import (SynthConfig, det_proto_from_gt, make_video,
                                          write_frames)
from vdetlib_tpu_torch.evaluation.vid_map import vid_map
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet
from vdetlib_tpu_torch.pipeline import runner as trunner
from vdetlib_tpu_torch.pipeline.fused import fused_to_protos, make_fused_pipeline
from vdetlib_tpu_torch.pipeline.fused_runner import fused_config_from_pipeline
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.video import detect as tdetect
from vdetlib_tpu_torch.video import link as tlink
from vdetlib_tpu_torch.video import mgp as tmgp
from vdetlib_tpu_torch.video import perturb as tperturb
from vdetlib_tpu_torch.video import rescore as trescore
from vdetlib_tpu_torch.video import track as ttrack

torch.set_num_threads(2)

LENGTHS = (6, 8)
NATIVE_HW = (HW, (2 * HW[0], 2 * HW[1]))  # the frames' stored sizes
TOL_SCORE, TOL_BOX = 0.01, 0.5
DET_FILES = ("detect", "mgp", "rescored", "final")
TRACK_FILES = ("track", "perturbed", "tubelets")
ALL_FILES = ("detect", "mgp", "track", "perturbed", "score", "rescored", "final", "tubelets")
STAGES = ("detect", "mgp", "track", "perturb", "rescore", "seq_nms")
# the tool's flags for both packages
CLI_FLAGS = ["--model", "tiny", "--num_classes", str(C), "--image_hw", *map(str, HW),
             "--max_rois", str(R), "--batch_size", "4", "--max_tracks", "8",
             "--anchor_thresh", "0.26", "--boost", "mean", "--bg_decay", "0.7",
             "--perturb_n", "3", "--stages", ",".join(STAGES)]


def _cfg(runner, detect, mgp, track, rescore, link, perturb, trk_cfg):
    """The sweep's config in either package: the fused config of
    tests/test_torch_fused_runner.py with the perturbation stage."""
    return runner.PipelineConfig(
        detect=detect.DetectOptions(batch_size=4, max_rois=R, image_hw=HW, score_thresh=0.2),
        mgp=mgp.MGPOptions(num_classes=C, max_boxes=24, image_hw=HW),
        track=track.TrackOptions(max_tracks=8, anchors_per_round=4, batch_size=4, image_hw=HW,
                                 anchor_thresh=0.26),
        tracker_cfg=trk_cfg,
        rescore=rescore.RescoreOptions(num_classes=C, max_boxes=24, max_tracks=8),
        link=link.LinkOptions(num_classes=C, max_boxes=24, max_paths=16),
        perturb=perturb.PerturbOptions(num_perturb=3),
        stages=STAGES,
    )


@pytest.fixture(scope="module")
def nets():
    return f32_nets()


@pytest.fixture(scope="module")
def tcfg(nets):
    return _cfg(trunner, tdetect, tmgp, ttrack, trescore, tlink, tperturb, nets.ttrk_cfg)


@pytest.fixture(scope="module")
def jcfg(nets):
    return _cfg(jrunner, jdetect, jmgp, jtrack, jrescore, jlink, jperturb, nets.jtrk_cfg)


@pytest.fixture(scope="module")
def models(nets):
    return trunner.Models(nets.tdet, nets.ttrk)


@pytest.fixture(scope="module")
def jmodels(nets):
    return jrunner.Models(nets.jdet, nets.jdp, nets.jtrk, nets.jtp)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """gen_synth's layout: NAME.vid.json, NAME.box.json, NAME.annot.json;
    proposals around the objects plus clutter, a varying count per frame."""
    root = tmp_path_factory.mktemp("staged_data")
    rng = np.random.default_rng(1)
    inputs, svs = [], []
    for i, (T, (h, w)) in enumerate(zip(LENGTHS, NATIVE_HW)):
        sv = make_video(SynthConfig(num_frames=T, height=h, width=w, num_classes=C,
                                    seed=31 + i), video=f"staged{i}")
        vid = write_frames(sv, str(root / "frames"))
        boxes = []
        for t, f in enumerate(vid["frames"]):
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
        svs.append(sv)
    return root, inputs, svs


@pytest.fixture(scope="module")
def sweep(tcfg, models, dataset, tmp_path_factory):
    """The port's staged sweep at workers 1."""
    work = str(tmp_path_factory.mktemp("w1"))
    return trunner.run_videos(work, dataset[1], models, tcfg, device="cpu")


@pytest.fixture(scope="module")
def jax_sweep(jcfg, jmodels, dataset, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("jax_w1"))
    return jrunner.run_videos(work, dataset[1], jmodels, jcfg)


def _index_dets(proto):
    """{(frame, class): [(score, bbox)]} sorted for an order-free compare."""
    idx = {}
    for d in proto["detections"]:
        for sc in d["scores"]:
            idx.setdefault((d["frame"], sc["class_index"]), []).append(
                (sc["score"], tuple(d["bbox"])))
    for v in idx.values():
        v.sort()
    return idx


def assert_dets_close(got, want, score_tol, box_tol):
    """The same (frame, class) keys and counts; ``*_tol`` are (rtol, atol)."""
    a, b = _index_dets(want), _index_dets(got)
    assert set(a) == set(b)
    n = 0
    for key in a:
        assert len(a[key]) == len(b[key]), f"{key}: {len(a[key])} vs {len(b[key])} dets"
        for (sa, ba), (sb, bb) in zip(a[key], b[key]):
            np.testing.assert_allclose(sb, sa, rtol=score_tol[0], atol=score_tol[1],
                                       err_msg=str(key))
            np.testing.assert_allclose(bb, ba, rtol=box_tol[0], atol=box_tol[1],
                                       err_msg=str(key))
            n += 1
    assert n > 0, "nothing to compare"


def _tracks(proto):
    return [t["boxes"] if isinstance(t, dict) else t for t in proto["tracks"]]


def assert_tracks_close(got, want, box_tol):
    """The same track count, each track on the same frames, boxes within ``box_tol``."""
    tg, tw = _tracks(got), _tracks(want)
    assert len(tg) == len(tw) > 0
    for a, b in zip(tg, tw):
        assert [e["frame"] for e in a] == [e["frame"] for e in b]
        np.testing.assert_allclose([e["bbox"] for e in a], [e["bbox"] for e in b],
                                   rtol=box_tol[0], atol=box_tol[1])


JAX_TOL = dict(score_tol=(0, TOL_SCORE), box_tol=(0, TOL_BOX))


def _bytes(result, files=ALL_FILES):
    return {k: pathlib.Path(result[k]).read_bytes() for k in files
            if os.path.exists(result[k])}


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("stage", DET_FILES + TRACK_FILES)
def test_stage_files_match_jax(dataset, sweep, jax_sweep, stage):
    _, inputs, _ = dataset
    assert len(sweep) == len(jax_sweep) == len(inputs)
    if stage == "detect":  # the fixture's precondition: roi counts vary
        counts = [sum(b["frame"] == f["frame"] for b in box["boxes"])
                  for vid, box in inputs for f in vid["frames"]]
        assert len(set(counts)) > 1, "roi counts do not vary"
    for pg, pw in zip(sweep, jax_sweep):
        assert not pg.get("error") and not pw.get("error")
        got, want = proto_load(pg[stage]), proto_load(pw[stage])
        if stage in DET_FILES:
            assert_dets_close(got, want, **JAX_TOL)
        else:
            assert_tracks_close(got, want, JAX_TOL["box_tol"])
        if stage == "perturbed":
            assert all("perturb_scores" in e for t in _tracks(got) for e in t)
    assert pg["result"] == pg["final"]


def test_gt_detections_map_matches_jax(dataset, models, jmodels, tcfg, jcfg, tmp_path):
    """``run_video`` with a supplied det_proto (JAX's ``test_pipeline_map_reasonable``)."""
    from vdetlib_tpu.evaluation.vid_map import vid_map as j_vid_map

    _, inputs, svs = dataset
    vid, sv = inputs[0][0], svs[0]
    det = det_proto_from_gt(sv, dets_per_object=2, distractors_per_frame=2)
    cfg = dataclasses.replace(tcfg, stages=("mgp", "track", "rescore", "seq_nms"))
    jc = dataclasses.replace(jcfg, stages=cfg.stages)
    got = trunner.run_video(str(tmp_path / "t"), vid, None, models, cfg, det_proto=det,
                            device="cpu")
    want = jrunner.run_video(str(tmp_path / "j"), vid, None, jmodels, jc, det_proto=det)
    assert not os.path.exists(got["detect"])  # the det_proto is the mgp stage's input
    m, aps = vid_map([(proto_load(got["result"]), annot_proto(sv))])
    jm, _ = j_vid_map([(proto_load(want["result"]), annot_proto(sv))])
    assert m > 0.4, (m, aps)
    assert abs(m - jm) <= 0.01, (m, jm)
    assert_dets_close(proto_load(got["final"]), proto_load(want["final"]), **JAX_TOL)


# ---------------------------------------------------------------- the runner


def test_resume_writes_nothing(tcfg, models, dataset, sweep):
    stamps = {p: os.stat(p).st_mtime_ns for r in sweep for k, p in r.items()
              if k != "result" and os.path.exists(p)}
    assert len(stamps) == len(sweep) * len(ALL_FILES)
    again = trunner.run_videos(str(pathlib.Path(sweep[0]["final"]).parents[1]), dataset[1],
                               models, tcfg, device="cpu")
    assert again == sweep
    assert {p: os.stat(p).st_mtime_ns for p in stamps} == stamps


def test_deleted_final_reruns_seq_nms_only(tcfg, models, dataset, sweep, tmp_path):
    work = tmp_path / "w"
    shutil.copytree(pathlib.Path(sweep[0]["final"]).parents[1], work)
    r = {k: str(work / pathlib.Path(p).relative_to(pathlib.Path(sweep[0]["final"]).parents[1]))
         for k, p in sweep[1].items()}
    stamps = {k: os.stat(r[k]).st_mtime_ns for k in ALL_FILES}
    for k in ("final", "tubelets"):
        os.remove(r[k])
    with pytest.MonkeyPatch.context() as mp:
        calls = defaultdict(int)
        for name in ("det_vid", "mgp", "track_from_det", "tubelet_rescore"):
            fn = getattr(trunner, name)
            mp.setattr(trunner, name, lambda *a, _fn=fn, _n=name, **kw: (
                calls.__setitem__(_n, calls[_n] + 1), _fn(*a, **kw))[1])
        trunner.run_videos(str(work), dataset[1], models, tcfg, device="cpu")
    assert dict(calls) == {}
    for k in ALL_FILES:
        assert (os.stat(r[k]).st_mtime_ns == stamps[k]) == (k not in ("final", "tubelets")), k
    assert _bytes(r) == _bytes(sweep[1])


def test_det_proto_with_detect_stage_only(tcfg, models, dataset, tmp_path):
    """A supplied det_proto skips detection; with no stage that makes a
    det_proto, the input itself is written to detect.json (JAX's rule)."""
    _, inputs, svs = dataset
    det = det_proto_from_gt(svs[0])
    cfg = dataclasses.replace(tcfg, stages=("detect",))
    paths = trunner.run_video(str(tmp_path), inputs[0][0], inputs[0][1], models, cfg,
                              det_proto=det, device="cpu")
    assert paths["result"] == paths["detect"]
    assert proto_load(paths["detect"]) == det
    assert [k for k in ALL_FILES if os.path.exists(paths[k])] == ["detect"]


def _broken_video(vid_proto, name):
    """A vid_proto whose frame files do not exist (decoding fails)."""
    return dict(vid_proto, video=name,
                frames=[dict(f, path="missing/" + f["path"]) for f in vid_proto["frames"]])


@pytest.mark.parametrize("workers", [1, 2])
def test_keep_going_skips_a_bad_video(tcfg, models, dataset, sweep, tmp_path, workers):
    _, inputs, _ = dataset
    sweep3 = [(_broken_video(inputs[0][0], "stagedbad"), inputs[0][1])] + list(inputs)
    with pytest.raises(FileNotFoundError):
        trunner.run_videos(str(tmp_path / "strict"), sweep3, models, tcfg, workers=workers,
                           device="cpu")
    results = trunner.run_videos(str(tmp_path / "kg"), sweep3, models, tcfg, workers=workers,
                                 keep_going=True, device="cpu")
    assert results[0]["video"] == "stagedbad"
    assert results[0]["error"].startswith("FileNotFoundError: ")
    assert not os.path.exists(results[0]["result"])
    for r, r1 in zip(results[1:], sweep):
        assert not r.get("error")
        assert _bytes(r) == _bytes(r1)


def test_workers_2_equal_workers_1(tcfg, models, dataset, sweep, tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VDETLIB_TPU_METRICS", str(metrics))
        w2 = trunner.run_videos(str(tmp_path / "w2"), dataset[1], models, tcfg, workers=2,
                                device="cpu")
    record = [json.loads(line) for line in metrics.read_text().splitlines()][-1]
    assert record["stage"] == "pipeline"
    assert (record["frames"], record["videos"], record["workers"]) == (sum(LENGTHS), 2, 2)
    for r2, r1 in zip(w2, sweep):
        assert _bytes(r2) == _bytes(r1)


def test_prefetch_equals_no_prefetch(tcfg, models, dataset, sweep, tmp_path, monkeypatch):
    loads = []
    fn = trunner.load_frames_device
    monkeypatch.setattr(trunner, "load_frames_device",
                        lambda vid, hw: (loads.append(vid["video"]), fn(vid, hw))[1])
    monkeypatch.setenv("VDETLIB_TPU_STAGED_PREFETCH", "1")
    pf = trunner.run_videos(str(tmp_path / "pf"), dataset[1], models, tcfg, device="cpu")
    assert loads == [v["video"] for v, _ in dataset[1]]  # one decode a video, all prefetched
    for rp, r1 in zip(pf, sweep):
        assert _bytes(rp) == _bytes(r1)


def test_in_memory_frames_equal_frames_from_disk(tcfg, models, dataset, sweep, tmp_path):
    vid, box = dataset[1][0]  # stored at image_hw
    frames = trunner.load_frames_device(vid, HW)
    assert frames.shape == (LENGTHS[0],) + HW + (3,) and frames.dtype == np.uint8
    mem = trunner.run_videos(str(tmp_path / "mem"), [(vid, box, frames)], models, tcfg,
                             device="cpu")
    assert _bytes(mem[0]) == _bytes(sweep[0])
    with pytest.raises(ValueError, match="device_resize"):
        trunner.run_video(str(tmp_path / "dr"), vid, box, models,
                          dataclasses.replace(tcfg, detect=dataclasses.replace(
                              tcfg.detect, device_resize=True)), frames=frames, device="cpu")
    assert not os.path.exists(tmp_path / "dr")


def _with(cfg, section, **kw):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})


@pytest.mark.parametrize("section, kw, resume", [
    ("track", dict(snap_weight=0.5, snap_iou=0.4), ("detect", "mgp")),
    ("tracker_cfg", dict(template_eta=0.1, template_update_conf=0.3), ()),
    ("mgp", dict(flow_preset="accurate", flow_levels=2), ()),
], ids=["snap_weight", "template_eta", "flow_preset_accurate"])
def test_options_run_and_match_jax(tcfg, jcfg, models, jmodels, dataset, tmp_path, section, kw,
                                   resume):
    """The options the staged engine once refused run through ``run_videos``
    and every stage file stays within the JAX bounds above. Snapping starts
    JAX's chain from the port's ``detect`` and ``mgp`` files: a snap is a
    threshold decision (IoU > ``snap_iou`` before the blend), and from the
    start one of them sits on it (video 0, frame 5: IoU 0.3999 in the port,
    just above 0.4 in JAX, after 1e-3 px of upstream difference), which
    moves that track by 10.9 px."""
    got = trunner.run_videos(str(tmp_path / "t"), dataset[1], models, _with(tcfg, section, **kw),
                             device="cpu")
    for (vid, _), pg in zip(dataset[1], got):
        (tmp_path / "j" / vid["video"]).mkdir(parents=True)
        for stage in resume:
            shutil.copy(pg[stage], tmp_path / "j" / vid["video"])
    want = jrunner.run_videos(str(tmp_path / "j"), dataset[1], jmodels,
                              _with(jcfg, section, **kw))
    for pg, pw in zip(got, want):
        assert not pg.get("error") and not pw.get("error")
        for stage in DET_FILES:
            assert_dets_close(proto_load(pg[stage]), proto_load(pw[stage]), **JAX_TOL)
        for stage in TRACK_FILES:
            assert_tracks_close(proto_load(pg[stage]), proto_load(pw[stage]), JAX_TOL["box_tol"])


# ---------------------------------------------------------------- staged vs fused

PT, PR, BUDGET = 8, 12, 24


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    """tests/test_fused_parity.py's video and proposals."""
    tmp = tmp_path_factory.mktemp("parity")
    sv = make_video(SynthConfig(num_frames=PT, height=HW[0], width=HW[1], num_classes=C, seed=7),
                    video="vid_parity")
    vid = write_frames(sv, str(tmp))
    rng = np.random.default_rng(7)
    rois = np.zeros((PT, PR, 4), np.float32)
    for t in range(PT):
        x1 = rng.uniform(0, HW[1] - 10, PR)
        y1 = rng.uniform(0, HW[0] - 10, PR)
        w = rng.uniform(8, 60, PR)
        h = rng.uniform(8, 60, PR)
        rois[t] = np.stack([x1, y1, np.minimum(x1 + w, HW[1] - 1),
                            np.minimum(y1 + h, HW[0] - 1)], axis=1)
    box = {"video": vid["video"],
           "boxes": [{"frame": int(f["frame"]), "bbox": [float(v) for v in rois[t, r]]}
                     for t, f in enumerate(vid["frames"]) for r in range(PR)]}
    loader = FrameLoader(vid, target_hw=HW)
    frames = np.stack([img for _, img, _ in loader.iter_frames()])
    loader.close()
    return dict(tmp=tmp, vid=vid, box=box, rois=rois, frames=frames, fids=sv.frame_ids)


def _matched_cfg(trk_cfg, tubelet_boxes=False, min_matched_frac=0.0, track_stride=1,
                 score_thresh=0.005, mgp_window=1, bg_decay=1.0, snap_weight=0.0,
                 flow_preset="fast"):
    """tests/test_fused_parity.py's matched configuration as a PipelineConfig."""
    return trunner.PipelineConfig(
        detect=tdetect.DetectOptions(batch_size=4, max_rois=PR, image_hw=HW,
                                     score_thresh=score_thresh, regress=True),
        mgp=tmgp.MGPOptions(window=mgp_window, score_decay=0.9, nms_thresh=0.3,
                            max_boxes=BUDGET, num_classes=C, flow_preset=flow_preset),
        track=ttrack.TrackOptions(max_tracks=6, anchors_per_round=3, anchor_thresh=0.3,
                                  conf_thresh=0.5, cover_thresh=0.5, batch_size=4, image_hw=HW,
                                  frame_stride=track_stride, snap_weight=snap_weight),
        tracker_cfg=trk_cfg,
        rescore=trescore.RescoreOptions(match_thresh=0.5, top_ratio=0.5, boost="max",
                                        bg_decay=bg_decay, max_boxes=BUDGET, num_classes=C,
                                        max_tracks=6, tubelet_boxes=tubelet_boxes,
                                        min_matched_frac=min_matched_frac),
        link=tlink.LinkOptions(link_thresh=0.5, suppress_thresh=0.3, max_paths=8,
                               rescore="avg", max_boxes=BUDGET, num_classes=C, min_score=0.0,
                               backend="device"),
    )


_RUNS = [0]


def _staged(s, models, cfg, box=None):
    """The port's staged chain through ``run_video``: (final, tubelets, track)."""
    _RUNS[0] += 1
    paths = trunner.run_video(str(s["tmp"] / f"staged{_RUNS[0]}"), s["vid"],
                              box if box is not None else s["box"], models, cfg, device="cpu")
    return tuple(proto_load(paths[k]) for k in ("final", "tubelets", "track"))


def _fused(s, models, cfg, rois=None, roi_mask=None):
    """The port's fused pipeline at the matched FusedConfig: (final, tubelets, out)."""
    pipe = make_fused_pipeline(models.detector, models.tracker, cfg.tracker_cfg,
                               fused_config_from_pipeline(cfg))
    rois = s["rois"] if rois is None else rois
    with torch.no_grad():
        out = pipe(torch.from_numpy(s["frames"]), torch.from_numpy(rois), None,
                   None if roi_mask is None else torch.from_numpy(roi_mask))
    det_proto, tubelets = fused_to_protos(out, s["fids"], s["vid"]["video"])
    return det_proto, tubelets, out


def _jax_staged_from(s, nets, cfg, staged_dir):
    """JAX's staged chain resumed from the port's ``detect``, ``mgp`` and
    ``track`` files (resume-by-existence): JAX's rescoring and linking on
    the port's inputs, so that a flip upstream cannot hide in the compare.
    Returns (final, tubelets)."""
    opts = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jcfg = jrunner.PipelineConfig(
        detect=jdetect.DetectOptions(**dataclasses.asdict(opts["detect"])),
        mgp=jmgp.MGPOptions(**dataclasses.asdict(opts["mgp"])),
        track=jtrack.TrackOptions(**dataclasses.asdict(opts["track"])),
        tracker_cfg=nets.jtrk_cfg,
        rescore=jrescore.RescoreOptions(**dataclasses.asdict(opts["rescore"])),
        link=jlink.LinkOptions(**dataclasses.asdict(opts["link"])),
    )
    work = s["tmp"] / f"jax_from_{staged_dir.name}"
    (work / s["vid"]["video"]).mkdir(parents=True)
    for k in ("detect", "mgp", "track"):
        shutil.copy(staged_dir / s["vid"]["video"] / f"{k}.json", work / s["vid"]["video"])
    paths = jrunner.run_video(str(work), s["vid"], s["box"],
                              jrunner.Models(nets.jdet, nets.jdp, nets.jtrk, nets.jtp), jcfg)
    return proto_load(paths["final"]), proto_load(paths["tubelets"])


PARITY = dict(score_tol=(1e-4, 1e-5), box_tol=(1e-4, 1e-3))


def test_fused_matches_staged_final_dets(matched, models, nets):
    cfg = _matched_cfg(nets.ttrk_cfg)
    staged_det, _, _ = _staged(matched, models, cfg)
    fused_det, _, _ = _fused(matched, models, cfg)
    assert_dets_close(fused_det, staged_det, **PARITY)


def test_fused_matches_staged_at_track_stride2(matched, models, nets):
    """Stride 2 changes the track boxes here (the precondition), and the
    engines still agree."""
    cfg = _matched_cfg(nets.ttrk_cfg, track_stride=2)
    staged_det, _, staged_trk = _staged(matched, models, cfg)
    fused_det, _, _ = _fused(matched, models, cfg)
    assert_dets_close(fused_det, staged_det, **PARITY)
    assert len(staged_trk["tracks"]) > 0
    _, _, base_trk = _staged(matched, models, _matched_cfg(nets.ttrk_cfg))
    boxes = lambda tp: [tuple(tuple(b["bbox"]) for b in tr) for tr in _tracks(tp)]  # noqa: E731
    assert boxes(staged_trk) != boxes(base_trk), \
        "stride-2 track boxes equal stride 1's: the fixture no longer exercises the stride"


def test_fused_matches_staged_tubelets(matched, models, nets):
    cfg = _matched_cfg(nets.ttrk_cfg)
    _, staged_tub, _ = _staged(matched, models, cfg)
    _, fused_tub, _ = _fused(matched, models, cfg)
    assert len(staged_tub["tracks"]) == len(fused_tub["tracks"]) > 0
    for ta, tb in zip(staged_tub["tracks"], fused_tub["tracks"]):
        assert [(e["frame"], e["class_index"]) for e in ta] == \
            [(e["frame"], e["class_index"]) for e in tb]
        for ea, eb in zip(ta, tb):
            np.testing.assert_allclose(eb["score"], ea["score"], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(eb["bbox"], ea["bbox"], rtol=1e-4, atol=1e-3)


def test_fused_track_count_matches_staged(matched, models, nets):
    cfg = _matched_cfg(nets.ttrk_cfg)
    _, _, staged_trk = _staged(matched, models, cfg)
    _, _, out = _fused(matched, models, cfg)
    assert int(out.n_tracks) == len(staged_trk["tracks"]) > 0


def test_fused_matches_staged_with_matched_frac_gate(matched, models, nets):
    """The track-quality gate alone (with tubelet boxes: below)."""
    cfg = _matched_cfg(nets.ttrk_cfg, min_matched_frac=0.4)
    staged_det, staged_tub, _ = _staged(matched, models, cfg)
    fused_det, fused_tub, _ = _fused(matched, models, cfg)
    assert_dets_close(fused_det, staged_det, **PARITY)
    assert len(staged_tub["tracks"]) == len(fused_tub["tracks"])


def _tubelet_boxes_case(s, models, nets, cfg):
    """With tubelet boxes the port's fused pipeline equals its staged chain,
    and the staged chain's rescoring and linking equal JAX's staged ones on
    the same inputs, which JAX's tests/test_fused_parity.py holds equal to
    JAX's fused pipeline. Returns the staged final det_proto."""
    staged_det, staged_tub, _ = _staged(s, models, cfg)
    jax_det, jax_tub = _jax_staged_from(s, nets, cfg, s["tmp"] / f"staged{_RUNS[0]}")
    assert_dets_close(staged_det, jax_det, **PARITY)
    assert len(staged_tub["tracks"]) == len(jax_tub["tracks"]) > 0
    fused_det, fused_tub, _ = _fused(s, models, cfg)
    assert_dets_close(fused_det, staged_det, **PARITY)
    assert len(fused_tub["tracks"]) == len(staged_tub["tracks"])
    return staged_det


@pytest.mark.parametrize("kw", [dict(tubelet_boxes=True),
                                dict(tubelet_boxes=True, min_matched_frac=0.4)],
                         ids=["tubelet_boxes", "tubelet_boxes_matched_frac_gate"])
def test_tubelet_boxes_staged_matches_jax(matched, models, nets, kw):
    _tubelet_boxes_case(matched, models, nets, _matched_cfg(nets.ttrk_cfg, **kw))


@pytest.mark.parametrize("tubelet_boxes", [False, True])
def test_fused_matches_staged_varying_slot_layout(matched, models, nets, tubelet_boxes):
    """score_thresh 0.26 and a 2-hop MGP window: the per-frame slot layout
    varies (asserted), the regression fixture of the fused-MGP class
    alignment (CLAUDE.md, "Parity-test blind spots")."""
    cfg = _matched_cfg(nets.ttrk_cfg, tubelet_boxes=tubelet_boxes, score_thresh=0.26,
                       mgp_window=2, bg_decay=0.7)
    if tubelet_boxes:
        staged_det = _tubelet_boxes_case(matched, models, nets, cfg)
    else:
        staged_det, _, _ = _staged(matched, models, cfg)
    det_proto = proto_load(str(matched["tmp"] / f"staged{_RUNS[0]}" / "vid_parity" /
                               "detect.json"))
    per_frame = defaultdict(list)
    for d in det_proto["detections"]:
        for sc in d["scores"]:
            per_frame[d["frame"]].append(sc["class_index"])
    layouts = {f: tuple(v) for f, v in sorted(per_frame.items())}
    assert len(set(layouts.values())) > 1, f"the slot layout does not vary: {layouts}"
    if not tubelet_boxes:
        fused_det, _, _ = _fused(matched, models, cfg)
        assert_dets_close(fused_det, staged_det, **PARITY)


def test_fused_matches_staged_varying_roi_counts(matched, models, nets):
    """The staged chain reads a box_proto with a varying per-frame prefix of
    the proposals; the fused pipeline the padded array with decoy boxes in
    the masked slots, which must not leak."""
    s = matched
    rng = np.random.default_rng(11)
    counts = rng.integers(PR // 3, PR + 1, size=PT)
    counts[0] = PR
    assert len(set(int(c) for c in counts)) > 1
    box = {"video": s["vid"]["video"],
           "boxes": [{"frame": int(f["frame"]), "bbox": [float(v) for v in s["rois"][t, r]]}
                     for t, f in enumerate(s["vid"]["frames"]) for r in range(int(counts[t]))]}
    rois = np.array(s["rois"], np.float32, copy=True)
    roi_mask = np.zeros((PT, PR), bool)
    for t in range(PT):
        roi_mask[t, :int(counts[t])] = True
        rois[t, int(counts[t]):] = [HW[1] * 0.25, HW[0] * 0.25, HW[1] * 0.75, HW[0] * 0.75]
    cfg = _matched_cfg(nets.ttrk_cfg)
    staged_det, _, _ = _staged(s, models, cfg, box=box)
    fused_det, _, _ = _fused(s, models, cfg, rois=rois, roi_mask=roi_mask)
    assert_dets_close(fused_det, staged_det, **PARITY)


@pytest.mark.parametrize("kw, trk", [
    (dict(snap_weight=0.5), {}),
    ({}, dict(template_eta=0.1, template_update_conf=0.3)),
    (dict(snap_weight=0.5, track_stride=2), dict(template_eta=0.1, template_update_conf=0.3)),
    (dict(flow_preset="accurate"), {}),
    (dict(snap_weight=0.5, tubelet_boxes=True, flow_preset="accurate"),
     dict(template_eta=0.1, template_update_conf=0.3)),
], ids=["snap_weight", "template_eta", "snap_and_eta_stride2", "flow_preset_accurate",
        "every_option"])
def test_fused_matches_staged_with_options(matched, nets, kw, trk):
    """Snapping, EMA templates and the flow pyramid: the fused pipeline
    equals the staged chain case for case (snapping reads the same
    candidate set, packed differently; ``snap_to_dets`` ignores the order)."""
    trk_cfg = dataclasses.replace(nets.ttrk_cfg, **trk)
    models = trunner.Models(nets.tdet, nets.ttrk)
    cfg = _matched_cfg(trk_cfg, **kw)
    staged_det, staged_tub, staged_trk = _staged(matched, models, cfg)
    fused_det, fused_tub, out = _fused(matched, models, cfg)
    assert_dets_close(fused_det, staged_det, **PARITY)
    assert int(out.n_tracks) == len(staged_trk["tracks"]) > 0
    assert len(staged_tub["tracks"]) == len(fused_tub["tracks"])


def test_fused_matches_staged_multiscale_tracker(matched, nets):
    trk_cfg = TrackerConfig(num_scales=3, dtype=torch.float32)
    trk = TrackerNet(trk_cfg)
    trk.load_state_dict(nets.ttrk.state_dict())
    models = trunner.Models(nets.tdet, trk.eval())
    cfg = _matched_cfg(trk_cfg)
    staged_det, staged_tub, _ = _staged(matched, models, cfg)
    fused_det, fused_tub, _ = _fused(matched, models, cfg)
    assert_dets_close(fused_det, staged_det, **PARITY)
    assert len(staged_tub["tracks"]) == len(fused_tub["tracks"]) > 0
    for ta, tb in zip(staged_tub["tracks"], fused_tub["tracks"]):
        assert [e["frame"] for e in ta] == [e["frame"] for e in tb]
        np.testing.assert_allclose([e["bbox"] for e in tb], [e["bbox"] for e in ta],
                                   rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------- the tool


def _tool(nets, argv, monkeypatch):
    """The port's tool with the float32 nets in place of its seeded init."""
    import vdetlib_tpu_torch.weights as tweights

    monkeypatch.setattr(tweights, "init_detector", lambda *a, **kw: nets.tdet)
    monkeypatch.setattr(tweights, "init_tracker", lambda *a, **kw: nets.ttrk)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pipeline_tool.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cli_run(nets, dataset, tmp_path_factory):
    """The port's tool, the default (staged) engine, ``--device cpu --eval``."""
    root, _, _ = dataset
    tmp = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        rc, printed = _tool(nets, [str(root), str(tmp / "work"), *CLI_FLAGS, "--device", "cpu",
                                   "--eval"], mp)
    return tmp, rc, printed


def _tool_cfg(nets, **rescore):
    """The tool's PipelineConfig for CLI_FLAGS, by hand."""
    return trunner.PipelineConfig(
        detect=tdetect.DetectOptions(batch_size=4, max_rois=R, image_hw=HW, score_thresh=0.05),
        mgp=tmgp.MGPOptions(num_classes=C, image_hw=HW),
        track=ttrack.TrackOptions(max_tracks=8, image_hw=HW, anchor_thresh=0.26),
        tracker_cfg=TrackerConfig(),
        rescore=trescore.RescoreOptions(num_classes=C, boost="mean", bg_decay=0.7, **rescore),
        link=tlink.LinkOptions(num_classes=C),
        perturb=tperturb.PerturbOptions(num_perturb=3),
        stages=STAGES,
    )


def _tool_paths(work, vid):
    return {k: str(work / vid["video"] / f"{k}.json") for k in ALL_FILES}


def test_pipeline_tool_staged_matches_direct_run_videos(nets, dataset, cli_run, models):
    root, inputs, _ = dataset
    tmp, rc, printed = cli_run
    assert rc == 0
    direct = trunner.run_videos(str(tmp / "direct"), inputs, models, _tool_cfg(nets),
                                device="cpu")
    assert json.loads((tmp / "direct" / "pipeline_config.json").read_text()) == \
        json.loads((tmp / "work" / "pipeline_config.json").read_text())
    pairs = []
    for r, (vid, _) in zip(direct, inputs):
        assert _bytes(_tool_paths(tmp / "work", vid)) == _bytes(r)
        assert len(_bytes(r)) == len(ALL_FILES)
        pairs.append((proto_load(r["final"]),
                      proto_load(str(root / f"{vid['video']}.annot.json"))))
    m, _ = vid_map(pairs)
    assert re.search(r"^mAP = ([0-9.]+) over 2 videos$", printed, re.M).group(1) == f"{m:.4f}"


def test_pipeline_tool_staged_workers_2(nets, dataset, cli_run, tmp_path, monkeypatch):
    root, inputs, _ = dataset
    tmp, _, _ = cli_run
    rc, _ = _tool(nets, [str(root), str(tmp_path / "w2"), *CLI_FLAGS, "--device", "cpu",
                         "--staged_workers", "2"], monkeypatch)
    assert rc == 0
    for vid, _ in inputs:
        assert _bytes(_tool_paths(tmp_path / "w2", vid)) == \
            _bytes(_tool_paths(tmp / "work", vid))


@pytest.fixture(scope="module")
def jax_cli_run(nets, dataset, tmp_path_factory):
    """The JAX tool with the same flags and the same float32 nets."""
    import vdetlib_tpu.nn.detector as jdetector

    root, _, _ = dataset
    tmp = tmp_path_factory.mktemp("jax_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdetector, "init_detector", lambda *a, **kw: (nets.jdet, nets.jdp))
        mp.setattr(jtrack, "init_tracker", lambda *a, **kw: (nets.jtrk, nets.jtp))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = j_pipeline_tool.main([str(root), str(tmp), *CLI_FLAGS, "--eval"])
    return tmp, rc, out.getvalue()


def test_pipeline_tool_staged_matches_jax_tool(dataset, cli_run, jax_cli_run):
    _, inputs, _ = dataset
    tmp, _, printed = cli_run
    jtmp, jrc, jprinted = jax_cli_run
    assert jrc == 0
    for vid, _ in inputs:
        got, want = _tool_paths(tmp / "work", vid), _tool_paths(jtmp, vid)
        for k in DET_FILES:
            assert_dets_close(proto_load(got[k]), proto_load(want[k]), **JAX_TOL)
        for k in TRACK_FILES:
            assert_tracks_close(proto_load(got[k]), proto_load(want[k]), JAX_TOL["box_tol"])
    m = float(re.search(r"^mAP = ([0-9.]+)", printed, re.M).group(1))
    jm = float(re.search(r"^mAP = ([0-9.]+)", jprinted, re.M).group(1))
    assert abs(m - jm) <= 0.01


def test_pipeline_config_matches_jax_tool(cli_run, jax_cli_run):
    tmp, _, _ = cli_run
    jtmp, _, _ = jax_cli_run
    want = json.loads((jtmp / "pipeline_config.json").read_text())
    got = json.loads((tmp / "work" / "pipeline_config.json").read_text())
    # the one key whose value names the framework's dtype
    assert got["tracker_cfg"].pop("dtype") == "torch.bfloat16"
    assert "bfloat16" in want["tracker_cfg"].pop("dtype")
    assert got == want


def test_pipeline_tool_staged_tubelet_boxes(nets, dataset, models, tmp_path, monkeypatch):
    """``--tubelet_boxes`` with the staged engine: the tool's files equal a
    direct ``run_videos`` call's (both engines against JAX's tool:
    tests/test_torch_fused_runner.py)."""
    root, inputs, _ = dataset
    rc, _ = _tool(nets, [str(root), str(tmp_path / "work"), *CLI_FLAGS, "--device", "cpu",
                         "--tubelet_boxes"], monkeypatch)
    assert rc == 0
    direct = trunner.run_videos(str(tmp_path / "direct"), inputs, models,
                                _tool_cfg(nets, tubelet_boxes=True), device="cpu")
    for r, (vid, _) in zip(direct, inputs):
        assert _bytes(_tool_paths(tmp_path / "work", vid)) == _bytes(r)


def test_pipeline_tool_needs_a_card_unless_told(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    root, _, _ = dataset
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline_tool.main([str(root), str(tmp_path / "w"), *CLI_FLAGS])
    assert not any(p.name.endswith(".json") for p in tmp_path.rglob("*"))
