"""Detector architectures behind the harness: the base architecture's FLOP
counts and reference outputs are those the harness gave before it named
architectures; a second detector enters as an architecture file and a
configuration alone and runs through the fused sweep; a configuration that
names no architecture, an unknown one, or other precision stages than the
architecture reads is refused."""

import ast
import json
import os
import time
import types

import pytest
import torch

from portbench import architectures
from portbench.harness.common import Cell
from portbench.reference.precision import SHARED
from portbench.run import read_metric
from portbench.yardstick import flops as yf

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")


def _json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _config(name):
    return _json(os.path.join(PORTBENCH, "configs", name + ".json"))


# The yardstick's readings at the accepted cells' configurations before the
# detector's terms moved into its architecture module (bit for bit).
PARENT = {
    "fused85": {"detect/backbone": 15769976832000.0, "detect/roi_align": 760381440000.0,
                "detect/head": 1371767808000.0, "track/features": 427991040000.0,
                "track/ncc_scan": 135409041408.0, "mgp/flow": 36297676800.0,
                "mgp/nms_grouped": 112803840.0, "rescore": 12881920.0,
                "seq_nms": 4301591040.0},
    "fused282": {"detect/backbone": 52319217254400.0, "detect/roi_align": 2522677248000.0,
                 "detect/head": 4551041433600.0, "track/features": 1403412480000.0,
                 "track/ncc_scan": 440646107136.0, "mgp/flow": 121424371200.0,
                 "mgp/nms_grouped": 374243328.0, "rescore": 42737664.0,
                 "seq_nms": 14388495360.0},
    "stream": {"detect": 6739623936000.0, "nms": 3110400000.0, "mgp/flow": 13827686400.0,
               "mgp/nms": 27993600000.0, "track/features": 318504960000.0,
               "track/ncc": 101147738112.0, "track/backtrack": 199338491904.0},
    "mfu.sweep": 0.6891888174095026,
    "mfu.stream": 1.5480044708403153,
}


@pytest.mark.parametrize("case", sorted(PARENT))
def test_base_flops_are_the_parents(case):
    c = _config("tcnn_stream_base" if case.endswith("stream") else "tcnn_fused_base")
    if case.startswith("fused"):
        got = yf.fused_dispatch_flops(architectures.of(c), c["detector"], c["tracker"],
                                      c["fused"], int(case[5:]), c["max_rois"])
        assert list(got) == list(PARENT[case])
    elif case == "stream":
        got = yf.stream_chunk_flops(architectures.of(c), c["detector"], c["tracker"],
                                    c["stream"], c["image_hw"])
        assert list(got) == list(PARENT[case])
    elif case == "mfu.sweep":
        got = read_metric(case, {"config": c, "window_frames": [351, 108, 480, 223, 443],
                                 "window_s": 51.25})
    else:
        got = read_metric(case, {"config": c, "chunks_ms": [480.5, 500.25, 470.0]})
    assert got == PARENT[case]


@pytest.mark.parametrize("lower", [False, True], ids=["nominal", "control"])
@pytest.mark.parametrize("name", ["tcnn_fused_tiny", "tcnn_stream_tiny"])
def test_base_reference_through_the_architecture_is_nets_detector(name, lower):
    from portbench.harness.models import draw_state, reference_models
    from portbench.reference.nets import Detector, TrackerNet
    from portbench.reference.precision import Precisions

    config = _json(os.path.join(DATA, name + ".json"))
    cpu = torch.device("cpu")
    arch = architectures.of(config)
    prec = Precisions.from_config(config["precision"], arch.STAGES, lower=lower)
    direct = Detector(config["detector"], prec).eval()
    state = arch.shape_head(draw_state(direct, 2**31 + 5, cpu), config["weights"])
    direct.load_state_dict(state)
    trk_state = draw_state(TrackerNet(config["tracker"], prec), 1, cpu)
    via, _ = reference_models(config, state, trk_state, cpu, lower=lower)
    assert type(via) is Detector and repr(via.prec) == repr(prec)
    g = torch.Generator().manual_seed(7)
    h, w = config["image_hw"]
    images = torch.randn((2, h, w, 3), generator=g) * 50.0
    xy = torch.rand((2, 12, 2), generator=g) * torch.tensor([w * 0.6, h * 0.6])
    rois = torch.cat([xy, xy + 8 + torch.rand((2, 12, 2), generator=g) * 40], -1)
    with torch.no_grad():
        want, got = direct(images, rois), via(images, rois)
    assert want[0].dtype == torch.float32 and want[1].shape == (2, 12, config["num_classes"], 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# A second detector, written as a file of its own: image means pooled at
# stride 16, ROI align, one hidden layer, heads named ``score`` and
# ``delta``, and one number-format stage (``toy_head``) of its own.
TOY = '''
"""A toy detector: means of 16x16 patches, ROI align, one hidden layer."""

import types

import torch
import torch.nn.functional as F
from torch import nn

from portbench.harness.models import same
from portbench.reference.nets import roi_align as plain_roi_align
from portbench.yardstick.flops import roi_align_flops

STAGES = ("toy_head",)
STRIDE = 16


class Toy(nn.Module):
    def __init__(self, det, align, cast):
        super().__init__()
        self.k = det["num_classes"]
        self.config = types.SimpleNamespace(num_classes=self.k,
                                            pixel_mean=tuple(det["pixel_mean"]),
                                            pixel_scale=det["pixel_scale"])
        self.embed = nn.Linear(3 * det["pool"] ** 2, det["hidden"])
        self.score = nn.Linear(det["hidden"], self.k)
        self.delta = nn.Linear(det["hidden"], 4 * self.k)
        self.align, self.cast = align, cast

    def forward(self, images, rois):
        feats = F.avg_pool2d(images.float().permute(0, 3, 1, 2), STRIDE).permute(0, 2, 3, 1)
        x = self.align(feats, rois).flatten(-3)
        x = F.relu(F.linear(self.cast(x), self.cast(self.embed.weight), self.embed.bias))
        deltas = F.linear(x, self.delta.weight, self.delta.bias)
        return (F.linear(x, self.score.weight, self.score.bias),
                deltas.reshape(deltas.shape[:-1] + (self.k, 4)))


def program(config, device):
    from vdetlib_tpu_torch.nn.heads import roi_align

    det = config["detector"]
    same("detector", {"num_classes": config["num_classes"]}, det)
    with torch.device(device):
        return Toy(det, lambda f, r: roi_align(f, r, STRIDE, det["pool"]), lambda x: x).eval()


def shape_head(state, weights):
    state["score.weight"] = state["score.weight"] * weights["cls_logit_scale"]
    state["delta.weight"] = state["delta.weight"] * weights["bbox_scale"]
    return state


def reference(arch, prec):
    p = prec.toy_head
    net = Toy(arch, lambda f, r: plain_roi_align(f, r, STRIDE, arch["pool"], p),
              lambda x: p.cast(x).float())
    net.arch, net.prec = arch, prec
    return net


def detect_flops(det, h, w, n_rois):
    hidden, k = det["hidden"], det["num_classes"]
    return {"detect/backbone": 3.0 * h * w,
            "detect/roi_align": roi_align_flops(h // STRIDE, w // STRIDE, 3, det["pool"], n_rois),
            "detect/head": n_rois * 2.0 * hidden * (3 * det["pool"] ** 2 + 5 * k)}
'''


def toy_config():
    config = _json(os.path.join(DATA, "tcnn_fused_tiny.json"))
    config.update({
        "name": "toy_fused_tiny", "architecture": "toy_fc", "model": "toy",
        "detector": {"num_classes": config["num_classes"], "pool": 4, "hidden": 32,
                     "pixel_mean": [102.98, 115.95, 122.77], "pixel_scale": 0.01},
        "precision": {**{s: config["precision"][s] for s in SHARED}, "toy_head": "float32"},
    })
    return config


@pytest.mark.parametrize("side", ["sound", "fault"])
def test_second_architecture_enters_as_files(side, tmp_path, monkeypatch):
    """The toy detector through the fused sweep's engine on the CPU, with
    the resolver pointed at the folder that holds its file; with a fault
    planted in its program (the class logits rolled by one class), not
    correct."""
    import importlib

    (tmp_path / "toy_fc.py").write_text(TOY, encoding="utf-8")
    monkeypatch.setattr(architectures, "FOLDER", str(tmp_path))
    config = toy_config()
    toy = architectures.of(config)
    if side == "fault":
        real = toy.program

        def broken(config, device):
            det = real(config, device)
            det.register_forward_hook(lambda m, i, out: (out[0].roll(1, -1), out[1]))
            return det
        monkeypatch.setattr(toy, "program", broken)
    traffic = _json(os.path.join(DATA, "tiny_sweep.json"))
    engine = importlib.import_module("portbench.engines." + config["engine"])
    args = types.SimpleNamespace(seed=2**31 + 29, seconds=0.2, trace=0)
    out = engine.run(Cell("toy_fused_tiny.tiny_sweep", 1, config, traffic, [], []), args,
                     torch.device("cpu"), time.perf_counter())
    nums = {n: v for n, v, _ in out["checks"]}
    if side == "fault":
        assert not out["correct"] and nums["final_mismatch"] > 0.1, out["checks"]
        return
    assert out["correct"] and nums["empty_checked"] == 0, out["checks"]
    mfu = read_metric("mfu.sweep", {"config": config, "window_frames": [48, 64], "window_s": 1.0})
    assert mfu > 0


def _refused(config, match):
    with pytest.raises(SystemExit, match=match):
        architectures.of(config)


@pytest.mark.parametrize("fault", ["no_key", "unknown", "path", "missing_stage", "extra_stage"])
def test_configuration_without_its_architecture_is_refused(fault):
    config = _config("tcnn_fused_base")
    if fault == "no_key":
        del config["architecture"]
        _refused(config, "names no \"architecture\"")
    elif fault in ("unknown", "path"):
        config["architecture"] = "rfcn_resnet101" if fault == "unknown" else "../harness/models"
        _refused(config, "no detector architecture")
    elif fault == "missing_stage":
        del config["precision"]["head_hidden"]
        _refused(config, "precision needs exactly the stages")
    else:
        config["precision"]["ps_roi_pool"] = "float32"
        _refused(config, "precision needs exactly the stages")


@pytest.mark.parametrize("name", sorted(n[:-3] for n in os.listdir(
    os.path.join(PORTBENCH, "architectures")) if n.endswith(".py") and n != "__init__.py"))
def test_architecture_reference_imports_nothing_of_the_port(name):
    """Only ``program`` imports the port, inside itself; the rest of the
    module, the reference with it, imports none of it."""
    with open(os.path.join(PORTBENCH, "architectures", name + ".py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        inner = [n for n in ast.walk(node) if isinstance(n, (ast.Import, ast.ImportFrom))]
        for imp in inner:
            mods = ([a.name for a in imp.names] if isinstance(imp, ast.Import)
                    else [imp.module or ""])
            port = [m for m in mods if m.split(".")[0] in ("vdetlib_tpu_torch", "vdetlib_tpu",
                                                           "jax", "jaxlib", "flax")]
            assert not port or (isinstance(node, ast.FunctionDef) and node.name == "program"
                                and not any(m.split(".")[0] != "vdetlib_tpu_torch"
                                            for m in port)), (name, mods)
    mod = architectures.load(name)
    for attr in ("STAGES", "program", "shape_head", "reference", "detect_flops"):
        assert hasattr(mod, attr), (name, attr)
    assert not set(mod.STAGES) & set(SHARED)
