"""Each cell's engine end to end on the CPU at the tiny preset: the reference
agrees with the port, a broken timed path reads not correct, the control
(the reference one number format down) reads above the limits, no module of
JAX or the JAX package gets loaded, and a configuration, a mix and a metric
added as files alone are found by name."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
import types

import pytest
import torch

from portbench.harness.common import Cell, load_cell

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")
CELLS = {"sweep": ("tcnn_fused_tiny", "tiny_sweep"), "stream": ("tcnn_stream_tiny", "tiny_feed")}


def tiny_cell(kind):
    conf, mix = CELLS[kind]
    with open(os.path.join(DATA, conf + ".json"), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(DATA, mix + ".json"), encoding="utf-8") as f:
        traffic = json.load(f)
    return Cell(kind, 1, config, traffic, [], [])


def run_cell(kind, trace=0, seconds=0.2, seed=2**31 + 11):
    import importlib

    cell = tiny_cell(kind)
    engine = importlib.import_module("portbench.engines." + cell.config["engine"])
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return engine.run(cell, args, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("kind", ["sweep", "stream"])
def test_cell_runs_correct_on_the_cpu(kind):
    out = run_cell(kind)
    assert out["correct"], out["checks"]
    nums = {n: v for n, v, _ in out["checks"]}
    assert nums["empty_checked"] == 0
    assert out["attempted"] >= 1
    e2e = out["end_to_end"]
    assert e2e["setup_s"] > 0 and (e2e.get("frames_per_s", 0) > 0 or (
        e2e["stream_frames_per_s"] > 0 and out["counts"]["full_chunks"] > 0))


@pytest.mark.parametrize("kind,fault", [
    ("sweep", "answer"), ("sweep", "half_batch"), ("sweep", "state"), ("stream", "answer"),
    ("stream", "state")])
def test_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    """Faults planted underneath the timed path: an answer altered where it is
    produced (seq-NMS scores; the stream's kept slots), half of each detection
    batch left out, a tracker step that returns its state unchanged (the
    sweep's tracks frozen at their anchors; the stream's NCC update)."""
    import vdetlib_tpu_torch.pipeline.fused as pf
    import vdetlib_tpu_torch.video.stream as vs
    from portbench.calibrate import frozen_tracks

    if fault == "answer" and kind == "sweep":
        real = pf.seq_nms_batch

        def altered(*a, **k):
            scores, ids = real(*a, **k)
            return torch.where(scores > 0, scores + 0.1, scores), ids
        monkeypatch.setattr(pf, "seq_nms_batch", altered)
    elif fault == "half_batch":
        real = pf._detect_step

        def half(model, frames, rois, regress):
            h = frames.shape[0] // 2
            probs, boxes = real(model, frames[:h], rois[:h], regress)
            return torch.cat([probs, probs]), torch.cat([boxes, boxes])
        monkeypatch.setattr(pf, "_detect_step", half)
    elif kind == "sweep":
        monkeypatch.setattr(pf, "track_batch", frozen_tracks(pf.track_batch))
    elif fault == "answer":
        real = vs.batched_nms

        def dropped(*a, **k):
            keep = real(*a, **k)
            return keep & (torch.arange(keep.shape[-1]) % 7 != 0)
        monkeypatch.setattr(vs, "batched_nms", dropped)
    else:
        real = vs.ncc_update

        def frozen(feat, box, tpl, cfg):
            _, peak = real(feat, box, tpl, cfg)
            return box, peak
        monkeypatch.setattr(vs, "ncc_update", frozen)
    out = run_cell(kind)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["sweep", "stream"])
def test_control_reads_above_the_limits(kind):
    from portbench.calibrate import readings

    cell = tiny_cell(kind)
    r = readings(cell, 2**31 + 3, torch.device("cpu"))
    limits = cell.config["check"]["limits"]
    assert all(r["program"][k] <= lim for k, lim in limits.items() if k in r["program"])
    failed = [k for k, lim in limits.items() if k in r["control"] and r["control"][k] > lim]
    assert failed, r


@pytest.mark.parametrize("kind", ["sweep", "stream"])
def test_dry_run_loads_no_jax(kind, tmp_path):
    """A traced CPU dry run in a fresh process, then the run's own check."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        sys.path.insert(0, {HERE!r})
        from test_portbench_cells import run_cell
        from portbench.harness.common import forbidden_modules
        out = run_cell({kind!r}, trace=1)
        assert out["correct"], out["checks"]
        assert out["context"]["trace"]["window_s"] > 0
        bad = forbidden_modules()
        print("FORBIDDEN", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["TMPDIR"] = str(tmp_path)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    assert "FORBIDDEN []" in p.stdout


def test_files_alone_add_a_config_a_mix_and_a_metric(tmp_path):
    """A configuration, a traffic mix and a per-layer metric that exist only
    as new files and new BENCHMARK.json entries are found by name."""
    from portbench import run as runmod

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    shutil.copy(os.path.join(DATA, "tcnn_fused_tiny.json"),
                tmp_path / "portbench" / "configs" / "dummy_cfg.json")
    shutil.copy(os.path.join(DATA, "tiny_sweep.json"), tmp_path / "portbench" / "traffic" /
                "dummy_mix.json")
    (tmp_path / "portbench" / "metrics" / "dummy_frames.sweep.py").write_text(
        "def read(ctx):\n    return float(sum(v['t'] for v in ctx['videos']))\n")
    bench["configs"].append({"name": "dummy_cfg", "source": "https://example.org/x",
                             "file": "portbench/configs/dummy_cfg.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_frames.sweep", "unit": "frames",
                               "better": "higher", "source": "program_counter", "layer": "test",
                               "moves": "frames_per_s", "workloads": ["dummy_cfg.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("dummy_cfg.dummy_mix", root=str(tmp_path))
    assert cell.config["engine"] == "fused_sweep" and cell.traffic["shard_videos"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy_frames.sweep"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    got = runmod.read_metric("dummy_frames.sweep", {"videos": [{"t": 3}, {"t": 4}]},
                             metrics_dir=str(tmp_path / "portbench" / "metrics"))
    assert got == 7.0
