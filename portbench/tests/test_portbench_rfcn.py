"""The R-FCN cell behind the harness: its architecture file resolves and builds
the port's detector held to the configuration, its ``precision`` section is
held to the architecture's stages, the cell runs ``correct`` through the fused
sweep's engine on the CPU at ``rfcn_tiny`` (and not with a fault planted in
the program's pooling), its FLOP terms are the port's, and each of its
per-layer readers reads synthetic events and returns None without its span."""

import copy
import json
import os
import time
import types

import pytest
import torch

from portbench import architectures
from portbench.harness.common import Cell
from portbench.harness.trace import reduce_events
from portbench.run import read_metric
from portbench.tests.test_portbench_metrics import events
from portbench.yardstick import flops as yf
from portbench.yardstick.work import bound_s

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
CELL = "tcnn_fused_rfcn101.vid_sweep"


def _json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _config():
    return _json(os.path.join(PORTBENCH, "configs", "tcnn_fused_rfcn101.json"))


def _tiny():
    return _json(os.path.join(HERE, "data", "tcnn_fused_rfcn_tiny.json"))


def test_architecture_resolves_and_builds_the_preset():
    config = _tiny()
    arch = architectures.of(config)
    assert arch is architectures.load("rfcn_r101")
    assert arch.STAGES == ("backbone", "reduce", "score_maps", "psroi")
    det = arch.program(config, torch.device("cpu"))
    assert type(det).__name__ == "RFCN" and not det.training
    state = arch.shape_head({k: v.clone() for k, v in det.state_dict().items()},
                            {"cls_logit_scale": 2.0, "background_scale": 0.0, "bbox_scale": 0.5})
    k2 = 7 * 7  # the background's class maps lead the class maps' channels
    assert not state["cls.weight"][:k2].any()
    assert torch.equal(state["cls.weight"][k2:], 2.0 * det.cls.weight[k2:])
    assert torch.equal(state["bbox.weight"], 0.5 * det.bbox.weight)
    # every key of the section is held to the preset
    for key, value in (("conv5_dilation", 1), ("ps_pool", 3), ("trunk_dtype", "float32"),
                       ("stage_sizes", [1, 1, 2, 1])):
        bad = copy.deepcopy(config)
        bad["detector"][key] = value
        with pytest.raises(SystemExit, match="is not the configuration's"):
            arch.program(bad, torch.device("cpu"))


@pytest.mark.parametrize("fault", ["missing", "extra", "base_stages"])
def test_precision_is_held_to_the_stages(fault):
    config = _config()
    if fault == "missing":
        del config["precision"]["psroi"]
    elif fault == "extra":
        config["precision"]["head_hidden"] = "bf16"
    else:
        config["precision"] = _json(os.path.join(PORTBENCH, "configs",
                                                 "tcnn_fused_base.json"))["precision"]
    with pytest.raises(SystemExit, match="precision needs exactly the stages"):
        architectures.of(config)


def test_configuration_and_cell_are_in_the_benchmark():
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    conf = {c["name"]: c for c in bench["configs"]}["tcnn_fused_rfcn101"]
    assert conf["reduced"] == ["video_length", "image_hw"]
    config = _json(os.path.join(ROOT, conf["file"]))
    base = _config_of(bench, "tcnn_fused_base")
    # the fused section is the base sweep's, field for field, but the input size
    assert {k: v for k, v in config["fused"].items() if k != "image_hw"} == \
        {k: v for k, v in base["fused"].items() if k != "image_hw"}
    assert config["fused"]["image_hw"] == config["image_hw"] == [560, 992]
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("tcnn_fused_rfcn101",
                                                                "vid_sweep", 1)
    new = [m for m in bench["per_layer"] if m.get("workloads") == [CELL]]
    assert sorted(m["name"] for m in new) == sorted(NEW)
    for m in new:
        assert os.path.isfile(os.path.join(PORTBENCH, "metrics", m["name"] + ".py"))
    # every reader of the base sweep reads this cell too
    for m in bench["per_layer"]:
        if m["name"].endswith(".sweep"):
            assert m["workloads"] == ["tcnn_fused_base.vid_sweep", CELL], m["name"]


def test_a_port_without_rfcn_is_refused_before_any_card_work(monkeypatch):
    """A tree whose port has no ``build_detector`` (the benchmark laid over an
    older port) stops at once with a message."""
    from vdetlib_tpu_torch.nn import presets

    monkeypatch.delattr(presets, "build_detector")
    with pytest.raises(SystemExit, match="builds no R-FCN"):
        architectures.of(_tiny()).program(_tiny(), torch.device("cpu"))


def _config_of(bench, name):
    conf = {c["name"]: c for c in bench["configs"]}[name]
    return _json(os.path.join(ROOT, conf["file"]))


@pytest.mark.parametrize("side", ["sound", "fault"])
def test_cell_runs_correct_on_the_cpu(side, monkeypatch):
    """The fused sweep's engine at ``rfcn_tiny`` on the CPU; with the
    program's position-sensitive channels mirrored (bin (i, j) pooled from
    the channel of bin (k-1-i, j)), not correct."""
    import importlib

    import vdetlib_tpu_torch.nn.rfcn as prfcn

    if side == "fault":
        real = prfcn.psroi_pool

        def mirrored(maps, rois, k, stride=16):
            B, H, W, ch = maps.shape
            flipped = maps.reshape(B, H, W, ch // (k * k), k, k).flip(-2).reshape(B, H, W, ch)
            return real(flipped, rois, k, stride)
        mirrored.calls, mirrored.rois = real.calls, real.rois  # the counters it advances
        monkeypatch.setattr(prfcn, "psroi_pool", mirrored)
    config = _tiny()
    traffic = _json(os.path.join(HERE, "data", "tiny_sweep.json"))
    engine = importlib.import_module("portbench.engines." + config["engine"])
    args = types.SimpleNamespace(seed=2**31 + 53, seconds=0.2, trace=0)
    out = engine.run(Cell("tcnn_fused_rfcn_tiny.tiny_sweep", 1, config, traffic, [], []), args,
                     torch.device("cpu"), time.perf_counter())
    nums = {n: v for n, v, _ in out["checks"]}
    if side == "fault":
        assert not out["correct"], out["checks"]
        return
    assert out["correct"] and nums["empty_checked"] == 0, out["checks"]
    assert out["end_to_end"]["frames_per_s"] > 0 and out["end_to_end"]["setup_s"] > 0


def test_detect_flops_are_the_ports():
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.utils import flops as pf

    config = _config()
    arch = architectures.of(config)
    for hw, r in (((560, 992), 300), ((96, 128), 16), ((600, 1000), 64)):
        want = {c.name: c.flops for c in pf.detect_flops(
            detector_preset(config["model"], num_classes=config["num_classes"]), *hw, r)}
        assert arch.detect_flops(config["detector"], *hw, r) == want
    trunk, hf, wf = arch.trunk(config["detector"], 560, 992)
    assert (hf, wf) == (35, 62) and trunk == pytest.approx(216.217e9, rel=1e-5)
    n_bytes, n_ops = arch.psroi_work(config["detector"], 560, 992, 300)
    # the maps: 35 x 62 cells x 7^2 x (31 + 4) float32, read once
    assert n_bytes == 4.0 * (35 * 62 * 49 * 35 + 300 * 4 + 300 * 35)
    assert n_ops == arch.detect_flops(config["detector"], 560, 992, 300)["detect/roi_align"]


NEW = ("detect.psroi_share.rfcn_sweep", "roofline.psroi.rfcn_sweep",
       "roofline.backbone.rfcn_sweep")
# the base sweep's readers that the cell reports too, read at its configuration
SHARED = ("detect.device_ms_per_frame.sweep", "mfu.sweep")


def _ctx(trace):
    return {"trace": trace, "config": _config(), "videos": [{"t": 282, "tp": 288}],
            "window_frames": [351, 108, 480], "window_s": 51.5}


def test_readers_on_synthetic_events():
    tr = reduce_events(events([
        ("fused.detect", 0, 60, []),
        ("detect.backbone", 1, 35, [("conv", 2, 30)]),
        ("detect.psroi", 38, 50, [("gather", 40, 4)])]))
    ctx = _ctx(tr)
    got = {n: read_metric(n, ctx) for n in NEW + SHARED}
    assert got["detect.device_ms_per_frame.sweep"] == pytest.approx(34.0 / 282)
    assert got["detect.psroi_share.rfcn_sweep"] == pytest.approx(100.0 * 4 / 34)
    config = ctx["config"]
    arch = architectures.of(config)
    n_bytes, n_ops = arch.psroi_work(config["detector"], 560, 992, 300)
    assert got["roofline.psroi.rfcn_sweep"] == pytest.approx(
        100.0 * bound_s(288 * n_bytes, 288 * n_ops) / 0.004)
    flops = arch.detect_flops(config["detector"], 560, 992, 300)["detect/backbone"]
    assert got["roofline.backbone.rfcn_sweep"] == pytest.approx(
        100.0 * 288 * flops / (0.030 * yf.PEAK_BF16_FLOPS))
    window = sum(sum(yf.fused_dispatch_flops(arch, config["detector"], config["tracker"],
                                             config["fused"], t, 300).values())
                 for t in (351, 108, 480))
    assert got["mfu.sweep"] == pytest.approx(100.0 * window / (51.5 * yf.PEAK_BF16_FLOPS))


def test_readers_return_none_without_their_spans():
    """A trace of the base sweep (no ``detect.*`` span) reads nothing; the
    window's MFU reads the window alone."""
    ctx = _ctx(reduce_events(events([("fused.seq_nms", 30, 90, [("amax", 40, 1)])])))
    for name in NEW + SHARED[:1]:
        assert read_metric(name, ctx) is None, name
    assert read_metric("mfu.sweep", ctx) > 0
