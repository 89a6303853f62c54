"""The port's analytic FLOP model (``utils/flops.py``) and trace exporter
(``utils/profiling.py::device_trace``).

The model's counts equal JAX's exactly for the same configs (the ``tiny``
and ``base`` presets, ``bench.py``'s slice config, one and four videos),
with the card's classes of work in place of the TPU's units. As JAX's
``tests/test_flops.py`` holds its model against XLA's cost analysis, the
detect step and the tracker features are held here against what
``torch.utils.flop_counter.FlopCounterMode`` counts on the CPU, within the
same ±15% (the slack is the elementwise glue the model leaves out)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vdetlib_tpu.nn.presets import detector_preset as j_detector_preset
from vdetlib_tpu.nn.tracker_net import TrackerConfig as JTrackerConfig
from vdetlib_tpu.pipeline.fused import FusedConfig as JFusedConfig
from vdetlib_tpu.utils import flops as JF
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
from vdetlib_tpu_torch.pipeline.fused import FusedConfig
from vdetlib_tpu_torch.utils import flops as F
from vdetlib_tpu_torch.utils import profiling

UNITS = {"MXU": F.MATMUL, "VPU": F.SIMT}
# bench.py's slice config (base, C = 31, 240x320, R = 64, A = 8, 32 paths)
BENCH = dict(image_hw=(240, 320), detect_batch=32, feat_batch=32, anchors_per_round=8,
             max_tracks=8, max_paths=32)


@pytest.mark.parametrize("videos", [1, 4])
@pytest.mark.parametrize("preset, fused_kw, t, r", [
    ("base", BENCH, 256, 64),
    ("base", dict(BENCH, track_stride=1, flow_preset="fast", mgp_window=2), 64, 64),
    ("tiny", dict(image_hw=(96, 128), max_paths=12, out_budget=24), 8, 12),
], ids=["bench", "base_stride1_fast", "tiny"])
def test_counts_equal_jax(preset, fused_kw, t, r, videos):
    got = F.fused_dispatch_flops(detector_preset(preset, num_classes=31), TrackerConfig(),
                                 FusedConfig(**fused_kw), t, r, videos=videos)
    want = JF.fused_dispatch_flops(j_detector_preset(preset, num_classes=31), JTrackerConfig(),
                                   JFusedConfig(**fused_kw), t, r, videos=videos)
    assert [(c.name, c.flops, c.unit, c.note) for c in got] == \
        [(c.name, c.flops, UNITS[c.unit], c.note) for c in want]
    assert F.total_flops(got) == JF.total_flops(want)


def test_component_functions_equal_jax():
    for preset in ("tiny", "small", "base"):
        bb, jbb = detector_preset(preset).backbone, j_detector_preset(preset).backbone
        for h, w in ((96, 128), (240, 320)):
            assert F.backbone_flops(bb, h, w) == JF.backbone_flops(jbb, h, w)
    for kw in ({}, {"num_scales": 3}, {"template_pool": 6}):
        cfg, jcfg = TrackerConfig(**kw), JTrackerConfig(**kw)
        assert F.tracker_feat_flops(cfg, 240, 320) == JF.tracker_feat_flops(jcfg, 240, 320)
        assert F.tracker_scan_flops(cfg, 240, 320, 128, 8) == \
            JF.tracker_scan_flops(jcfg, 240, 320, 128, 8)
    for preset in ("accurate", "fast", "fastest"):
        assert F.flow_flops(240, 320, 63, preset) == JF.flow_flops(240, 320, 63, preset)
    assert F.seq_nms_flops(64, 64, 30, 32) == JF.seq_nms_flops(64, 64, 30, 32)
    assert F.nms_grouped_flops(64, 192) == JF.nms_grouped_flops(64, 192)
    assert F.rescore_flops(64, 8, 64, 31) == JF.rescore_flops(64, 8, 64, 31)
    assert F.mfu(1e12, 2.0) == 1e12 / (2.0 * 989e12)


def test_the_cards_peaks():
    """The H100 SXM's dense peaks at 700 W; the MFU divides by the bf16 one."""
    assert (F.PEAK_BF16_FLOPS, F.PEAK_F32_FLOPS, F.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S is F.HBM_BYTES_PER_S
    assert chip_smoke.F32_OPS_PER_S is F.PEAK_F32_FLOPS


def _counted(fn, *args):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


def test_detect_step_flops_match_the_counter():
    from vdetlib_tpu_torch.video.detect import _detect_step
    from vdetlib_tpu_torch.weights import init_detector

    h, w, b, r, c = 120, 160, 2, 8, 6
    cfg = detector_preset("tiny", num_classes=c, dtype=torch.float32)
    model = init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.head.dtype = model.head.fc0.dtype = torch.float32
    frames = torch.zeros((b, h, w, 3), dtype=torch.uint8)
    rois = torch.tensor([4.0, 4.0, 60.0, 60.0]).repeat(b, r, 1)
    counted = _counted(lambda f, rr: _detect_step(model, f, rr, True), frames, rois)
    bb = cfg.backbone
    hf, wf, cf = h // 16, w // 16, bb.stage_features[-1]
    ana = b * (F.backbone_flops(bb, h, w)
               + F.roi_align_flops(hf, wf, cf, cfg.roi_pool, r)
               + F.rcnn_head_flops(cfg.roi_pool, cf, cfg.head_hidden, c, r))
    assert ana == pytest.approx(counted, rel=0.15), (ana, counted, ana / counted)


def test_tracker_features_flops_match_the_counter():
    from vdetlib_tpu_torch.video.track import tracker_features
    from vdetlib_tpu_torch.weights import init_tracker

    h, w, b = 120, 160, 2
    cfg = TrackerConfig(dtype=torch.float32)
    model = init_tracker(cfg, torch.Generator().manual_seed(0), device="cpu")
    frames = torch.zeros((b, h, w, 3), dtype=torch.uint8)
    counted = _counted(lambda f: tracker_features(model, f), frames)
    ana = b * F.tracker_feat_flops(cfg, h, w)
    assert ana == pytest.approx(counted, rel=0.15), (ana, counted, ana / counted)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        with torch.profiler.record_function("fused.seq_nms"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / profiling.TRACE_FILE
    assert path.stat().st_size > 0
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "fused.seq_nms" in names
    with profiling.device_trace(None):  # the hook left in place: nothing written
        pass
    assert os.listdir(tmp_path) == ["trace"]
