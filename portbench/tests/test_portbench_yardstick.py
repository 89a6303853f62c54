"""The frozen yardstick against the port's own FLOP model at the cells' shapes,
and the yardstick's independence from the port."""

import ast
import json
import os

import pytest

from portbench import architectures
from portbench.yardstick import flops as yf
from portbench.yardstick import work

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)


def _config(name):
    with open(os.path.join(PORTBENCH, "configs", name + ".json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("t", [32, 85, 320, 480])
def test_fused_flops_equal_the_ports(t):
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig
    from vdetlib_tpu_torch.utils import flops as pf

    c = _config("tcnn_fused_base")
    fcfg = c["fused"]
    port = pf.fused_dispatch_flops(
        detector_preset("base", num_classes=31), TrackerConfig(),
        FusedConfig(**{**fcfg, "image_hw": tuple(fcfg["image_hw"])}), t, c["max_rois"])
    mine = yf.fused_dispatch_flops(architectures.of(c), c["detector"], c["tracker"], fcfg, t,
                                   c["max_rois"])
    assert {x.name: x.flops for x in port} == mine
    assert (yf.PEAK_BF16_FLOPS, yf.PEAK_F32_FLOPS, yf.HBM_BYTES_PER_S) == (
        pf.PEAK_BF16_FLOPS, pf.PEAK_F32_FLOPS, pf.HBM_BYTES_PER_S)


def test_stream_chunk_flops_compose_the_ports_components():
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.utils import flops as pf

    c = _config("tcnn_stream_base")
    det, trk = detector_preset("base", num_classes=31), TrackerConfig()
    h, w = c["image_hw"]
    s = c["stream"]
    got = yf.stream_chunk_flops(architectures.of(c), c["detector"], c["tracker"], s, c["image_hw"])
    hf, wf = h // 16, w // 16
    assert got["detect"] == s["chunk"] * (
        pf.backbone_flops(det.backbone, h, w)
        + pf.roi_align_flops(hf, wf, 512, 7, s["max_rois"])
        + pf.rcnn_head_flops(7, 512, 1024, 31, s["max_rois"]))
    assert got["track/features"] == s["chunk"] * pf.tracker_feat_flops(trk, h, w)
    assert got["mgp/flow"] == pf.flow_flops(h, w, 2 * s["chunk"], preset="fastest")
    # one lane-step of the scan, as the port prices 2A lanes x T steps
    one = (pf.tracker_scan_flops(trk, h, w, 1, 1)
           - pf.roi_align_flops(h // 4, w // 4, 96, 8, 2)) / 2
    assert yf.ncc_step_flops(c["tracker"], h, w) == one


def test_flow_bound_matches_the_kernel_count():
    # chip_smoke.py's bound of kernel A: bytes of the two bf16 levels and the
    # field, 30 operations a pixel and shift
    t, (h, w) = 64, (240, 320)
    ops = 2 * ((t - 1) * 60 * 80 * 121 * 30 + t * h * w * 7)
    assert work.fused_flow(t, (h, w), "fastest") == max(
        (t * h * w * 3 + 2 * (t - 1) * 60 * 80 * 8) / yf.HBM_BYTES_PER_S,
        ops / yf.PEAK_F32_FLOPS)


def test_nms_pairs_and_bounds():
    assert work.nms_pairs([0, 1, 2, 4]) == 0 + 0 + 1 + 6
    full = work.stream_nms(32, 30, 64, [64] * (32 * 30))
    empty = work.stream_nms(32, 30, 64, [0] * (32 * 30))
    assert full > empty > 0


def test_yardstick_and_reference_import_nothing_of_the_port():
    for sub in ("yardstick", "reference"):
        folder = os.path.join(PORTBENCH, sub)
        for name in os.listdir(folder):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(folder, name), encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] in ("__future__", "math", "statistics", "dataclasses",
                                               "numpy", "torch", "portbench"), (name, m)
