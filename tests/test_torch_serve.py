"""Port parity and behaviour: the serving daemon (``vdetlib_tpu_torch/cli/serve.py``).

- ``try_lock``: JAX's four cases (tests/test_serve.py), one parametrised test.
- Two concurrent port daemons (``--device cpu --once``, subprocesses with
  seeded random tiny weights): each video processed once, the queue
  drained, no lock left.
- The port's daemon against JAX's ``serve.main``, both with the float32
  tiny nets of tests/torch_fused_common.py (C=4, 96×128, R=16), on each
  engine: ``final.json`` with the same (frame, class) keys and counts,
  scores within 0.01 and boxes within 0.5 px; ``tubelets.json`` with the
  same track count, each track on the same frames with boxes within 0.5 px
  (the cross-framework bound of tests/test_torch_staged_runner.py). The
  fused engine runs at a bucket of 8 frames in both packages, as
  tests/test_torch_fused_runner.py does; the track seeding threshold is
  0.26 in both (the random nets' scores sit near 1/C, below serve's 0.3).
- ``serve_config`` equals the config JAX's ``serve`` builds, field for field
  through ``dump_config``, at the defaults and with every quality knob.
- The port's own behaviour, byte for byte: the quality knobs change the
  scores; a video without its box proto is served by the staged engine with
  the files of ``run_video``; a video failing on both engines is
  quarantined and the daemon exits 0; a ``KernelError`` or a CUDA fault
  leaves the daemon with no retry and no quarantine; without a card and
  without ``--device cpu`` the daemon raises and writes nothing.
"""

import dataclasses
import functools
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import vdetlib_tpu.nn.detector as jdetector
import vdetlib_tpu.pipeline.fused_runner as jfr
import vdetlib_tpu.pipeline.runner as jrunner
import vdetlib_tpu.video.track as jtrack
import vdetlib_tpu_torch.pipeline.fused_runner as tfr
import vdetlib_tpu_torch.pipeline.runner as trunner
import vdetlib_tpu_torch.video.track as ttrack
from tests.torch_fused_common import HW, C, R, f32_nets
from vdetlib_tpu.cli import serve as jserve
from vdetlib_tpu_torch.cli import serve
from vdetlib_tpu_torch.data.synth import SynthConfig, annot_proto, make_video, write_frames
from vdetlib_tpu_torch.kernels.build import KernelError
from vdetlib_tpu_torch.nn.tracker_net import TrackerNet
from vdetlib_tpu_torch.protos import proto_dump, proto_load

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
LENGTHS = (6, 8)
NATIVE_HW = (HW, (2 * HW[0], 2 * HW[1]))  # the frames' stored sizes
TOL_SCORE, TOL_BOX = 0.01, 0.5
ANCHOR_THRESH = 0.26
SMALL_BUCKET = 8
FLAGS = ["--model", "tiny", "--num_classes", str(C), "--image_hw", *map(str, HW),
         "--max_rois", str(R), "--once"]
KNOBS = ["--bg_decay", "0.5", "--boost", "mean", "--min_matched_frac", "0.2",
         "--track_scales", "2", "--tubelet_boxes"]
EVERY_KNOB = KNOBS + ["--template_eta", "0.1", "--top_ratio", "0.4", "--snap_weight", "0.5",
                      "--snap_iou", "0.6", "--stat_floor", "3"]
STAGE_FILES = ("detect", "mgp", "track", "score", "rescored", "final", "tubelets")


# ---------------------------------------------------------------- try_lock


def _lock_case(case, lock):
    if case == "acquire_and_contend":
        assert serve.try_lock(lock)
        assert os.path.exists(os.path.join(lock, "owner.json"))
        assert not serve.try_lock(lock)  # a live owner blocks everyone else
    elif case == "reclaims_dead_owner":
        os.makedirs(lock)
        with open(os.path.join(lock, "owner.json"), "w") as f:
            # a pid that cannot exist (kernel pid_max is < 2**22 by default)
            json.dump({"host": socket.gethostname(), "pid": 2**22 + 17, "time": time.time()}, f)
        assert serve.try_lock(lock)
    elif case == "reclaims_by_ttl":
        os.makedirs(lock)
        with open(os.path.join(lock, "owner.json"), "w") as f:
            json.dump({"host": "some-other-host", "pid": 1, "time": time.time() - 100}, f)
        assert not serve.try_lock(lock, ttl_sec=1000)  # other host, fresh: blocked
        assert serve.try_lock(lock, ttl_sec=10)  # older than the TTL: reclaimed
    else:  # the owner crashed before writing owner.json
        os.makedirs(lock)
        old = time.time() - 100
        os.utime(lock, (old, old))
        assert not serve.try_lock(lock, ttl_sec=1000)
        assert serve.try_lock(lock, ttl_sec=10)


@pytest.mark.parametrize("case", ["acquire_and_contend", "reclaims_dead_owner",
                                  "reclaims_by_ttl", "reclaims_metadata_less_stale_dir"])
def test_try_lock(case, tmp_path):
    _lock_case(case, str(tmp_path / "v.lock"))


def test_try_lock_is_jax_verbatim():
    import inspect

    def body(fn):
        return inspect.getsource(fn).split('"""')[2]

    assert body(serve.try_lock) == body(jserve.try_lock)


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def nets():
    return f32_nets()


@pytest.fixture(scope="module")
def queue(tmp_path_factory):
    """A queue in gen_synth's layout: NAME.vid.json and NAME.box.json (JPEG
    frames, one video stored at twice the network size); proposals around
    the objects plus clutter, a varying count per frame."""
    root = tmp_path_factory.mktemp("queue")
    rng = np.random.default_rng(2)
    for i, (T, (h, w)) in enumerate(zip(LENGTHS, NATIVE_HW)):
        sv = make_video(SynthConfig(num_frames=T, height=h, width=w, num_classes=C,
                                    seed=41 + i), video=f"serve{i}")
        vid = write_frames(sv, str(root / "frames"))
        boxes = []
        for t, f in enumerate(vid["frames"]):
            k = rng.integers(0, sv.gt_boxes.shape[0], R)
            jit = rng.normal(0, 4, (R, 4))
            for r in range(R - int(rng.integers(0, 6))):
                b = np.clip(sv.gt_boxes[k[r], t] + jit[r], 0, [w - 1, h - 1] * 2)
                boxes.append({"frame": int(f["frame"]), "bbox": [float(v) for v in b]})
        proto_dump(vid, str(root / f"{sv.video}.vid.json"))
        proto_dump({"video": sv.video, "boxes": boxes}, str(root / f"{sv.video}.box.json"))
        proto_dump(annot_proto(sv), str(root / f"{sv.video}.annot.json"))
    return root


def _names(root):
    return sorted(p.name[:-len(".vid.json")] for p in root.glob("*.vid.json"))


def _like(net, cfg):
    """``net``'s float32 weights in a tracker built for ``cfg``'s scales."""
    trk = TrackerNet(dataclasses.replace(net.config, num_scales=cfg.num_scales))
    trk.load_state_dict(net.state_dict())
    return trk.eval()


def _port_nets(mp, nets):
    """The port's daemon with the float32 nets in place of its seeded init."""
    import vdetlib_tpu_torch.weights as tweights

    mp.setattr(tweights, "init_detector", lambda *a, **kw: nets.tdet)
    mp.setattr(tweights, "init_tracker", lambda cfg, *a, **kw: (
        nets.ttrk if cfg.num_scales == 1 else _like(nets.ttrk, cfg)))


def _seeding(mp):
    """Track seeding at ANCHOR_THRESH in both packages' daemons."""
    mp.setattr(ttrack, "TrackOptions", functools.partial(ttrack.TrackOptions,
                                                         anchor_thresh=ANCHOR_THRESH))
    mp.setattr(jtrack, "TrackOptions", functools.partial(jtrack.TrackOptions,
                                                         anchor_thresh=ANCHOR_THRESH))
    mp.setattr(tfr, "FusedEngine", functools.partial(tfr.FusedEngine, bucket=SMALL_BUCKET))
    mp.setattr(jfr, "FusedEngine", functools.partial(jfr.FusedEngine, bucket=SMALL_BUCKET))


def _port_main(nets, argv):
    with pytest.MonkeyPatch.context() as mp:
        _port_nets(mp, nets)
        _seeding(mp)
        return serve.main(argv)


@pytest.fixture(scope="module")
def served(nets, queue, tmp_path_factory):
    """The port's daemon on each engine: {engine: workdir}."""
    out = {}
    for engine in ("staged", "fused"):
        work = tmp_path_factory.mktemp(f"port_{engine}")
        assert _port_main(nets, [str(queue), str(work), *FLAGS, "--engine", engine,
                                 "--device", "cpu"]) == 0
        out[engine] = work
    return out


@pytest.fixture(scope="module")
def jax_served(nets, queue, tmp_path_factory):
    """JAX's daemon on each engine, with the same float32 nets."""
    out = {}
    for engine in ("staged", "fused"):
        work = tmp_path_factory.mktemp(f"jax_{engine}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdetector, "init_detector", lambda *a, **kw: (nets.jdet, nets.jdp))
            mp.setattr(jtrack, "init_tracker", lambda *a, **kw: (nets.jtrk, nets.jtp))
            _seeding(mp)
            assert jserve.main([str(queue), str(work), *FLAGS, "--engine", engine]) == 0
        out[engine] = work
    return out


def _index_dets(proto):
    idx = {}
    for d in proto["detections"]:
        for sc in d["scores"]:
            idx.setdefault((d["frame"], sc["class_index"]), []).append(
                (sc["score"], tuple(d["bbox"])))
    return {k: sorted(v) for k, v in idx.items()}


def _tracks(proto):
    return [t["boxes"] if isinstance(t, dict) else t for t in proto["tracks"]]


def _files(work, name, files=STAGE_FILES):
    return {k: (work / name / f"{k}.json").read_bytes() for k in files
            if (work / name / f"{k}.json").exists()}


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("engine", ["staged", "fused"])
def test_daemon_matches_jax(engine, queue, served, jax_served):
    work, jwork = served[engine], jax_served[engine]
    n_tracks = 0
    for name in _names(queue):
        a = _index_dets(proto_load(str(jwork / name / "final.json")))
        b = _index_dets(proto_load(str(work / name / "final.json")))
        assert set(a) == set(b) and len(a) > 0
        for key in a:
            assert len(a[key]) == len(b[key]), key
            for (sa, ba), (sb, bb) in zip(a[key], b[key]):
                assert abs(sa - sb) <= TOL_SCORE, (key, sa, sb)
                np.testing.assert_allclose(bb, ba, rtol=0, atol=TOL_BOX, err_msg=str(key))
        tw = _tracks(proto_load(str(jwork / name / "tubelets.json")))
        tg = _tracks(proto_load(str(work / name / "tubelets.json")))
        assert len(tw) == len(tg)
        for x, y in zip(tg, tw):
            assert [e["frame"] for e in x] == [e["frame"] for e in y]
            np.testing.assert_allclose([e["bbox"] for e in x], [e["bbox"] for e in y],
                                       rtol=0, atol=TOL_BOX)
        n_tracks += len(tw)
        # the engine asked for served the video: the staged files are there or not
        assert (work / name / "detect.json").exists() == (engine == "staged")
        assert (jwork / name / "detect.json").exists() == (engine == "staged")
    assert n_tracks > 0, "no video seeded a track"
    for w in (work, jwork):
        assert not list(w.glob("*.lock")) and not list(w.glob("*/quarantine.json"))


@pytest.mark.parametrize("argv", [[], EVERY_KNOB], ids=["defaults", "every_knob"])
def test_serve_config_matches_jax(argv, nets, queue, tmp_path, monkeypatch):
    """JAX's config, captured where its daemon hands it to ``run_video``."""
    captured = []

    def fake_run_video(workdir, vid, box, models, cfg, *a, **kw):
        captured.append(cfg)
        os.makedirs(os.path.join(workdir, vid["video"]), exist_ok=True)
        proto_dump({"video": vid["video"], "detections": []},
                   os.path.join(workdir, vid["video"], "final.json"))

    monkeypatch.setattr(jrunner, "run_video", fake_run_video)
    monkeypatch.setattr(jdetector, "init_detector", lambda *a, **kw: (nets.jdet, nets.jdp))
    monkeypatch.setattr(jtrack, "init_tracker", lambda *a, **kw: (nets.jtrk, nets.jtp))
    assert jserve.main([str(queue), str(tmp_path / "jax"), *FLAGS, *argv]) == 0
    assert len(captured) == len(_names(queue))
    jrunner.dump_config(str(tmp_path / "jax"), captured[0])
    cfg = serve.serve_config(serve.parse_args([str(queue), "w", *FLAGS, *argv]))
    trunner.dump_config(str(tmp_path / "port"), cfg)
    want = json.loads((tmp_path / "jax" / "pipeline_config.json").read_text())
    got = json.loads((tmp_path / "port" / "pipeline_config.json").read_text())
    # the one key whose value names the framework's dtype
    assert got["tracker_cfg"].pop("dtype") == "torch.bfloat16"
    assert "bfloat16" in want["tracker_cfg"].pop("dtype")
    assert got == want
    assert cfg.perturb is None and "perturb" not in cfg.stages


# ---------------------------------------------------------------- the port's behaviour


def test_two_concurrent_daemons(queue, tmp_path):
    """Two ``--once`` daemons over one queue (seeded random tiny weights):
    lock exclusion and a full drain."""
    work = tmp_path / "work"
    code = ("import sys; from vdetlib_tpu_torch.cli.serve import main; "
            "raise SystemExit(main(sys.argv[1:]))")
    argv = [str(queue), str(work), *FLAGS, "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = _names(queue)
    for name in names:
        assert (work / name / "final.json").exists(), outs
    processed = re.findall(r"processing (serve\d+)", "\n".join(outs))
    assert sorted(processed) == names, outs
    assert not list(work.glob("*.lock"))


def test_resume_writes_nothing(nets, queue, served):
    """A second ``once`` pass over a served workdir takes no video and
    rewrites no file."""
    for engine, work in served.items():
        stamps = {p: p.stat().st_mtime_ns for p in work.rglob("*.json")}
        args = serve.parse_args([str(queue), str(work), *FLAGS])
        with pytest.MonkeyPatch.context() as mp:
            _port_nets(mp, nets)
            models = serve.build_models(args, "cpu")
            cfg = serve.serve_config(args)
            assert serve.serve_loop(str(queue), str(work), models, cfg, engine=engine,
                                    once=True, device="cpu") == []
        assert {p: p.stat().st_mtime_ns for p in work.rglob("*.json")} == stamps


def test_quality_knobs_change_scores(nets, queue, served, tmp_path):
    """JAX's test_serve_quality_knobs: the pipeline tool's knobs reach the
    daemon's pipeline and change its scores."""
    assert _port_main(nets, [str(queue), str(tmp_path), *FLAGS, "--device", "cpu",
                             *KNOBS]) == 0
    name = _names(queue)[0]
    a = proto_load(str(served["staged"] / name / "final.json"))
    b = proto_load(str(tmp_path / name / "final.json"))
    assert len(a["detections"]) > 0 and len(b["detections"]) > 0
    sa = sorted(s["score"] for d in a["detections"] for s in d["scores"])
    sb = sorted(s["score"] for d in b["detections"] for s in d["scores"])
    assert sa != sb


def _cfg_and_models(nets, queue):
    args = serve.parse_args([str(queue), "w", *FLAGS])
    cfg = serve.serve_config(args)
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track,
                                                             anchor_thresh=ANCHOR_THRESH))
    return cfg, trunner.Models(nets.tdet, nets.ttrk)


def test_fused_without_box_proto_is_served_staged(nets, queue, served, tmp_path):
    """``--engine fused`` and a video without its box proto (a detect stage
    already in its workdir, as JAX's staged resume reads it): the staged
    engine serves it, with the files of a direct ``run_video``."""
    data = tmp_path / "data"
    data.mkdir()
    name = _names(queue)[1]
    vid = proto_load(str(queue / f"{name}.vid.json"))
    proto_dump(vid, str(data / f"{name}.vid.json"))
    detect = (served["staged"] / name / "detect.json").read_bytes()
    for w in ("serve", "direct"):
        (tmp_path / w / name).mkdir(parents=True)
        (tmp_path / w / name / "detect.json").write_bytes(detect)
    cfg, models = _cfg_and_models(nets, queue)
    recs = serve.serve_loop(str(data), str(tmp_path / "serve"), models, cfg, engine="fused",
                            once=True, device="cpu")
    assert [(r["video"], r["engine"], r["frames"]) for r in recs] == \
        [(name, "staged", len(vid["frames"]))]
    trunner.run_video(str(tmp_path / "direct"), vid, None, models, cfg, device="cpu")
    got, want = _files(tmp_path / "serve", name), _files(tmp_path / "direct", name)
    assert got == want and set(got) == set(STAGE_FILES)
    # and the served files equal the staged daemon's, which read the proposals
    assert got == _files(served["staged"], name)


def test_quarantine_after_both_engines_fail(nets, queue, tmp_path, monkeypatch):
    """A video failing on the fused engine and again on the staged one is
    quarantined; the daemon drains the rest of the queue and exits 0."""
    calls = []

    def bad_run(self, vid, loaded):
        calls.append(("fused", vid["video"]))
        raise ValueError("fused broke")

    real_run_video = trunner.run_video

    def run_video(workdir, vid, *a, **kw):
        calls.append(("staged", vid["video"]))
        if vid["video"] == "serve0":
            raise ValueError("staged broke")
        return real_run_video(workdir, vid, *a, **kw)

    monkeypatch.setattr(tfr.FusedEngine, "run", bad_run)
    monkeypatch.setattr(trunner, "run_video", run_video)
    work = tmp_path / "work"
    assert _port_main(nets, [str(queue), str(work), *FLAGS, "--engine", "fused",
                             "--device", "cpu"]) == 0
    assert calls == [("fused", "serve0"), ("staged", "serve0"), ("fused", "serve1"),
                     ("staged", "serve1")]
    q = json.loads((work / "serve0" / "quarantine.json").read_text())
    assert q["video"] == "serve0" and q["error"] == "ValueError: staged broke"
    assert not (work / "serve0" / "final.json").exists()
    assert (work / "serve1" / "final.json").exists()
    assert not list(work.glob("*.lock"))
    # a quarantined video is skipped until an operator deletes the marker
    cfg, models = _cfg_and_models(nets, queue)
    assert serve.serve_loop(str(queue), str(work), models, cfg, once=True, device="cpu") == []


def _accelerator_error():
    return torch.AcceleratorError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("where", ["fused", "staged"])
@pytest.mark.parametrize("make", [lambda: KernelError("CUDA kernel nms_grouped failed to "
                                                      "launch: cudaError 700"),
                                  _accelerator_error], ids=["KernelError", "AcceleratorError"])
def test_kernel_errors_leave_the_daemon(where, make, nets, queue, tmp_path, monkeypatch):
    """A kernel's error or a CUDA fault, on either engine: no staged retry,
    no quarantine, the lock released, the error raised out of the daemon."""
    calls = []

    def fused_run(self, vid, loaded):
        calls.append("fused")
        raise make()

    def run_video(*a, **kw):
        calls.append("staged")
        raise make()

    monkeypatch.setattr(tfr.FusedEngine, "run", fused_run)
    monkeypatch.setattr(trunner, "run_video", run_video)
    cfg, models = _cfg_and_models(nets, queue)
    err = type(make())
    with pytest.raises(err):
        serve.serve_loop(str(queue), str(tmp_path), models, cfg, engine=where, once=True,
                         device="cpu")
    assert calls == [where]
    assert not list(tmp_path.glob("*.lock")) and not list(tmp_path.rglob("quarantine.json"))
    assert issubclass(KernelError, RuntimeError)


def test_no_card_raises_and_writes_nothing(queue, tmp_path, nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the daemon would serve on it")
    work = tmp_path / "work"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([str(queue), str(work), *FLAGS])
    cfg, models = _cfg_and_models(nets, queue)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_loop(str(queue), str(work), models, cfg, once=True)
    assert not work.exists()
