"""R-FCN on the bottleneck ResNet trunk (``vdetlib_tpu_torch/nn/rfcn.py``)
against the benchmark's plain reference (``portbench/reference/rfcn.py``),
on the CPU.

- PS-ROI pooling against the reference's per-bin form: ROIs inside the
  map, across its edge, wholly outside it and smaller than one cell, at
  k = 7 and k = 3;
- ``rfcn_tiny`` on seeded weights (the BN affines drawn too) at float32
  against the reference in float32, and at the benchmark configuration's
  formats against the reference in them, where the reference one format
  down fails;
- ``rfcn_r101`` at its published widths, its parameters counted from the
  layer table; the deltas the same for every class;
- ``rfcn_tiny`` through the fused sweep to protos, its spans under
  ``fused.detect`` and its counters; the tools through the one
  constructor, and ``train_detector``'s refusal;
- the FLOP model priced by architecture, equal to the benchmark's.

The card-only case compares one detect batch at ``rfcn_r101``'s widths with
the reference on the card. The file imports no JAX.
"""

import json
import os

import pytest
import torch

from portbench import architectures
from portbench.harness.models import draw_state
from portbench.reference.precision import SHARED, Prec, Precisions
from portbench.reference.rfcn import RFCN as FrozenRFCN
from portbench.reference.rfcn import psroi_pool as naive_psroi_pool
from vdetlib_tpu_torch.nn import rfcn
from vdetlib_tpu_torch.nn.detector import preprocess_images
from vdetlib_tpu_torch.nn.presets import build_detector, detector_preset
from vdetlib_tpu_torch.utils import flops as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = os.path.join(ROOT, "portbench", "configs", "tcnn_fused_rfcn101.json")
C = 5
HW = (96, 128)


def _cell():
    with open(CELL, encoding="utf-8") as f:
        return json.load(f)


def _arch(cfg) -> dict:
    """An ``RFCNConfig`` as the references' width mapping."""
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(cfg).items()}


def _seeded(model, seed: int):
    """Seeded weights, with the BN affines drawn away from the identity."""
    g = torch.Generator().manual_seed(seed)
    state = draw_state(model, seed, torch.device("cpu"))
    for name, m in model.named_modules():
        if isinstance(m, rfcn.Affine):
            state[name + ".weight"] = 0.5 + torch.rand(m.weight.shape, generator=g)
            state[name + ".bias"] = 0.1 * torch.randn(m.bias.shape, generator=g)
    for name in ("reduce.bias", "cls.bias", "bbox.bias"):
        state[name] = 0.1 * torch.randn(state[name].shape, generator=g)
    state["cls.weight"] = state["cls.weight"] * 0.15
    state["bbox.weight"] = state["bbox.weight"] * 0.005
    model.load_state_dict(state)
    return state


def _inputs(b: int = 2, r: int = 12, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    h, w = HW
    images = torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)
    xy = torch.rand((b, r, 2), generator=g) * torch.tensor([w * 0.7, h * 0.7])
    rois = torch.cat([xy, xy + 6 + torch.rand((b, r, 2), generator=g) * 40], -1)
    return images, rois


def _rois(case: str, b: int, r: int, h: int, w: int, g):
    """ROIs in pixels for a map of h x w cells at stride 16."""
    H, W = 16 * h, 16 * w
    if case == "inside":
        xy = torch.rand((b, r, 2), generator=g) * torch.tensor([W * 0.6, H * 0.6])
        return torch.cat([xy, xy + 8 + torch.rand((b, r, 2), generator=g) * W * 0.4], -1)
    if case == "edge":  # across every side of the map
        lo = torch.rand((b, r, 2), generator=g) * 40 - 60
        hi = torch.tensor([W, H]) + torch.rand((b, r, 2), generator=g) * 40 - 20
        return torch.cat([lo, hi], -1)
    if case == "outside":  # wholly beyond the map's right or bottom edge
        xy = torch.tensor([W + 20.0, H + 20.0]) + torch.rand((b, r, 2), generator=g) * 50
        return torch.cat([xy, xy + 30], -1)
    # smaller than one cell, some of them a single pixel
    xy = torch.rand((b, r, 2), generator=g) * torch.tensor([W - 16.0, H - 16.0])
    return torch.cat([xy, xy + torch.rand((b, r, 2), generator=g) * 10], -1)


@pytest.mark.parametrize("k", [7, 3])
@pytest.mark.parametrize("case", ["inside", "edge", "outside", "small"])
def test_psroi_pool_is_the_naive_form(case, k):
    g = torch.Generator().manual_seed(k * 100 + len(case))
    b, r, h, w, groups = 2, 9, 6, 8, 4
    maps = torch.randn((b, h, w, groups * k * k), generator=g) * 10
    rois = _rois(case, b, r, h, w, g)
    calls, seen = rfcn.psroi_pool.calls, rfcn.psroi_pool.rois
    got = rfcn.psroi_pool(maps, rois, k)
    want = naive_psroi_pool(maps, rois, k, Prec("float32"))
    assert (rfcn.psroi_pool.calls, rfcn.psroi_pool.rois) == (calls + 1, seen + b * r)
    assert got.shape == (b, r, groups, k, k) and got.dtype == torch.float32
    # empty bins are 0 on both sides, exactly
    assert torch.equal(got == 0, want == 0)
    if case == "outside":
        assert not got.any()
    # the naive sum rounds to float32 at each of at most h*w = 48 adds (each
    # within 2^-24 of the running sum, |sum| <= 48 * 40), the port's
    # float64 table once: 48 * 48 * 40 * 2^-24 < 1e-4 before the division
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_rfcn_tiny_float32_is_the_plain_reference():
    cfg = detector_preset("rfcn_tiny", num_classes=C, dtype=torch.float32)
    port = build_detector(cfg).eval()
    stages = architectures.load("rfcn_r101").STAGES
    f32 = Precisions.from_config({s: "float32" for s in SHARED + stages}, stages)
    ref = FrozenRFCN(_arch(cfg), f32).eval()
    ref.load_state_dict(_seeded(port, 11))
    images, rois = _inputs()
    x = preprocess_images(images, cfg)
    with torch.no_grad():
        (s, d), (rs, rd) = port(x, rois), ref(x, rois)
    assert s.shape == (2, 12, C) and d.shape == (2, 12, C, 4)
    assert s.dtype == d.dtype == torch.float32
    # float32 on both sides, the same products in other orders (channels-last
    # convolutions, one fused map product, the pooling's float64 table):
    # a few float32 roundings of the logits
    scale = rs.abs().max()
    assert scale > 0.1
    torch.testing.assert_close(s, rs, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(d, rd, rtol=0, atol=1e-5 * rd.abs().max())


# Logits and deltas of the configuration's formats against the frozen
# reference at the same formats: the same products (bfloat16 trunk and
# reduction, float32 maps and pooling), so the port reads ~1e-6 of the
# logits' scale from other summation orders; the reference one format down
# (fp8 trunk and reduction, TF32 maps and pooling) moves them by ~1e-1.
# 1e-3 of the scale sits between, with room on both sides.
FORMAT_TOL = 1e-3


@pytest.mark.parametrize("side", ["port", "control"])
def test_rfcn_tiny_at_the_configurations_formats(side):
    cell = _cell()
    stages = architectures.load("rfcn_r101").STAGES
    cfg = detector_preset("rfcn_tiny", num_classes=C)
    assert cfg.dtype == torch.bfloat16
    port = build_detector(cfg).eval()
    arch = dict(_arch(cfg), pixel_mean=list(cfg.pixel_mean))
    nominal = FrozenRFCN(arch, Precisions.from_config(cell["precision"], stages)).eval()
    nominal.load_state_dict(_seeded(port, 13))
    images, rois = _inputs(seed=5)
    x = preprocess_images(images, cfg)
    with torch.no_grad():
        rs, rd = nominal(x, rois)
        if side == "port":
            s, d = port(x, rois)
        else:
            lower = FrozenRFCN(arch, Precisions.from_config(cell["precision"], stages,
                                                            lower=True)).eval()
            lower.load_state_dict(nominal.state_dict())
            s, d = lower(x, rois)
    gap = max(((s - rs).abs().max() / rs.abs().max()).item(),
              ((d - rd).abs().max() / rd.abs().max()).item())
    if side == "port":
        assert gap <= FORMAT_TOL, gap
    else:
        assert gap > FORMAT_TOL, gap


def _count_params(arch: dict) -> int:
    """R-FCN's parameters from the layer table: convolution kernels, two
    numbers a channel for each BN affine, biases on the head's convolutions."""
    n = 7 * 7 * 3 * arch["stem_features"] + 2 * arch["stem_features"]
    cin = arch["stem_features"]
    for si, (blocks, mid, out) in enumerate(zip(arch["stage_sizes"], arch["bottleneck_features"],
                                                arch["stage_features"])):
        for b in range(blocks):
            n += cin * mid + 9 * mid * mid + mid * out + 2 * (mid + mid + out)
            if b == 0:  # every first block changes channels (conv2) or stride
                n += cin * out + 2 * out
            cin = out
    k2, red, K = arch["ps_pool"] ** 2, arch["reduce_features"], arch["num_classes"]
    return n + cin * red + red + red * k2 * K + k2 * K + red * k2 * 4 + k2 * 4


def test_rfcn_r101_has_the_published_widths():
    cfg = detector_preset("rfcn_r101", num_classes=31)
    assert (tuple(cfg.stage_sizes), tuple(cfg.bottleneck_features), tuple(cfg.stage_features),
            cfg.conv5_dilation, cfg.reduce_features, cfg.ps_pool, cfg.dtype) == (
        (3, 4, 23, 3), (64, 128, 256, 512), (256, 512, 1024, 2048), 2, 1024, 7, torch.bfloat16)
    assert cfg.pixel_mean == (102.9801, 115.9465, 122.7717) and cfg.pixel_scale == 1.0
    with torch.device("meta"):
        model = build_detector(cfg)
    assert isinstance(model, rfcn.RFCN)
    assert sum(p.numel() for p in model.parameters()) == _count_params(_arch(cfg)) == 46_356_211
    assert (model.cls.out_channels, model.bbox.out_channels) == (1519, 196)
    stages = model.trunk.stages
    assert [len(s) for s in stages] == [3, 4, 23, 3]
    assert [s[0].conv1.stride[0] for s in stages] == [1, 2, 2, 1]
    assert [s[0].proj.stride[0] for s in stages] == [1, 2, 2, 1]
    assert all(blk.conv2.dilation[0] == 2 and blk.conv2.padding[0] == 2 for blk in stages[3])
    assert all(blk.conv2.dilation[0] == 1 for s in stages[:3] for blk in s)


def test_deltas_are_the_same_for_every_class():
    port = build_detector(detector_preset("rfcn_tiny", num_classes=C)).eval()
    _seeded(port, 17)
    images, rois = _inputs(seed=7)
    with torch.no_grad():
        _, d = port(preprocess_images(images, port.config), rois)
    assert d.abs().max() > 0
    assert torch.equal(d, d[:, :, :1].expand_as(d))


def _tiny_models(seed: int = 19):
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet

    det = build_detector(detector_preset("rfcn_tiny", num_classes=C)).eval()
    _seeded(det, seed)
    trk_cfg = TrackerConfig()
    trk = TrackerNet(trk_cfg).eval()
    trk.load_state_dict(draw_state(trk, seed + 1, torch.device("cpu")))
    return det, trk, trk_cfg


def _video(T: int = 20, seed: int = 23):
    from vdetlib_tpu_torch.data.synth import SynthConfig, box_proto, make_video

    sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=C,
                                seed=seed), video="rfcn")
    return sv, box_proto(sv)


def _small_bucket(monkeypatch):
    """The sweep's engine at a bucket of 8 frames (its default pads to 32)."""
    import functools

    import vdetlib_tpu_torch.pipeline.fused_runner as fr

    monkeypatch.setattr(fr, "FusedEngine", functools.partial(fr.FusedEngine, bucket=8))


def test_rfcn_tiny_through_the_fused_sweep(tmp_path, monkeypatch):
    """``run_videos_fused`` (``make_fused_pipeline`` inside, ``fused_to_protos``
    after) to protos under a CPU profile: one ``detect.<stage>`` span of each
    kind a detect batch, each inside ``fused.detect``; the counters advance
    by one call and 16 ROIs a frame for each batch."""
    from torch.profiler import ProfilerActivity, profile

    from vdetlib_tpu_torch.cli.serve import parse_args, serve_config
    from vdetlib_tpu_torch.data.synth import vid_proto_in_memory
    from vdetlib_tpu_torch.pipeline.fused_runner import run_videos_fused
    from vdetlib_tpu_torch.pipeline.runner import Models
    from vdetlib_tpu_torch.protos import proto_load

    _small_bucket(monkeypatch)
    det, trk, _ = _tiny_models()
    sv, boxes = _video(T=16)
    cfg = serve_config(parse_args(["q", "w", "--model", "rfcn_tiny", "--num_classes", str(C),
                                   "--image_hw", *map(str, HW), "--max_rois", "16",
                                   "--engine", "fused"]))
    calls, seen = rfcn.psroi_pool.calls, rfcn.psroi_pool.rois
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run_videos_fused(str(tmp_path), [(vid_proto_in_memory(sv), boxes, sv.frames)],
                               Models(det, trk), cfg)
    assert "error" not in res[0] and res[0]["counters"]["frames"] == 16
    final = proto_load(res[0]["final"])
    assert final["video"] == "rfcn" and final["detections"]
    assert all(1 <= d["frame"] <= 16 for d in final["detections"])
    assert proto_load(res[0]["tubelets"])["video"] == "rfcn"
    assert (rfcn.psroi_pool.calls - calls, rfcn.psroi_pool.rois - seen) == (2, 2 * 8 * 16)
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (lo, hi), = spans["fused.detect"]
    for name in ("detect.backbone", "detect.score_maps", "detect.psroi"):
        assert len(spans[name]) == 2, name
        assert all(lo <= s and e <= hi for s, e in spans[name]), name


@pytest.mark.parametrize("tool", ["detect", "stream", "pipeline", "serve"])
def test_tools_build_rfcn_through_the_one_constructor(tool, tmp_path, monkeypatch):
    import vdetlib_tpu_torch.nn.presets as presets
    from vdetlib_tpu_torch.data.synth import write_frames
    from vdetlib_tpu_torch.protos import proto_dump

    _small_bucket(monkeypatch)
    built = []
    real = presets.build_detector
    monkeypatch.setattr(presets, "build_detector", lambda c: built.append(c) or real(c))
    import vdetlib_tpu_torch.weights as weights

    monkeypatch.setattr(weights, "build_detector", presets.build_detector)
    sv, boxes = _video(T=8, seed=37)
    data = tmp_path / "data"
    vid = write_frames(sv, str(data / "frames"))
    proto_dump(vid, str(data / "rfcn.vid.json"))
    proto_dump(boxes, str(data / "rfcn.box.json"))
    flags = ["--model", "rfcn_tiny", "--num_classes", str(C), "--image_hw", *map(str, HW),
             "--max_rois", "16", "--device", "cpu"]
    vid_json, box_json, out = str(data / "rfcn.vid.json"), str(data / "rfcn.box.json"), tmp_path
    if tool == "detect":
        from vdetlib_tpu_torch.cli.detect import main
        rc = main([vid_json, box_json, str(out / "det.json"), *flags])
    elif tool == "stream":
        from vdetlib_tpu_torch.cli.stream import main
        rc = main([vid_json, str(out / "stream"), *flags, "--chunk", "4"])
    elif tool == "pipeline":
        from vdetlib_tpu_torch.cli.pipeline_tool import main
        rc = main([str(data), str(out / "work"), *flags, "--engine", "fused"])
    else:
        from vdetlib_tpu_torch.cli.serve import main
        rc = main([str(data), str(out / "served"), *flags, "--engine", "fused", "--once"])
    assert rc == 0
    assert [type(c) for c in built] == [rfcn.RFCNConfig]


def test_train_detector_refuses_rfcn_plainly(tmp_path):
    from vdetlib_tpu_torch.cli.train_detector import main

    # argparse refuses the model by name and lists the ones the trainer takes
    with pytest.raises(SystemExit) as exit_:
        main([str(tmp_path / "det.pt"), "--model", "rfcn_tiny", "--steps", "1", "--device", "cpu"])
    assert exit_.value.code == 2


def test_flop_model_prices_rfcn_as_the_benchmark_does():
    from portbench.yardstick import flops as yf
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig

    cell = _cell()
    arch = architectures.of(cell)
    h, w = cell["image_hw"]
    det_cfg = detector_preset(cell["model"], num_classes=cell["num_classes"])
    got = F.detect_flops(det_cfg, h, w, cell["max_rois"])
    assert {c.name: c.flops for c in got} == arch.detect_flops(cell["detector"], h, w,
                                                                cell["max_rois"])
    assert [c.unit for c in got] == [F.MATMUL, F.SIMT, F.MATMUL]
    # the published trunk at 560x992: 216.2 GFLOP, a 35x62 map
    assert F.rfcn_trunk_flops(det_cfg, h, w)[1:] == (35, 62)
    assert got[0].flops == pytest.approx(216.217e9, rel=1e-5)
    fcfg = FusedConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cell["fused"].items()
                          if k in FusedConfig.__dataclass_fields__})
    port = F.fused_dispatch_flops(det_cfg, TrackerConfig(), fcfg, 282, cell["max_rois"])
    bench = yf.fused_dispatch_flops(arch, cell["detector"], cell["tracker"], cell["fused"], 282,
                                    cell["max_rois"])
    assert {c.name: c.flops for c in port} == bench


def test_detect_step_flops_match_the_counter():
    """The analytic count of a tiny float32 detect step against what
    ``FlopCounterMode`` counts (convolutions; the pooling's gathers are not
    counted), within the ±15% that ``tests/test_torch_flops.py`` allows."""
    from torch.utils.flop_counter import FlopCounterMode

    from vdetlib_tpu_torch.video.detect import _detect_step

    h, w, b, r = 120, 160, 2, 8
    cfg = detector_preset("rfcn_tiny", num_classes=C, dtype=torch.float32)
    model = build_detector(cfg).eval()
    frames = torch.zeros((b, h, w, 3), dtype=torch.uint8)
    rois = torch.tensor([4.0, 4.0, 60.0, 60.0]).repeat(b, r, 1)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        _detect_step(model, frames, rois, True)
    ana = b * sum(c.flops for c in F.detect_flops(cfg, h, w, r))
    assert ana == pytest.approx(counter.get_total_flops(), rel=0.15)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: one detect batch of rfcn_r101 at its widths")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_rfcn_r101_detect_batch_on_the_card(cuda):
    """One detect batch (8 frames at the cell's 560x992, 300 ROIs) of the
    port's ``rfcn_r101`` against the frozen reference at the configuration's
    formats, on the benchmark's seeded weights; the reference one format
    down leaves the same tolerance."""
    from portbench.harness import videos

    cell = _cell()
    arch = architectures.of(cell)
    port = arch.program(cell, cuda)
    state = arch.shape_head(draw_state(port, 2**31 + 41, cuda), cell["weights"])
    port.load_state_dict(state)
    with open(os.path.join(ROOT, "portbench", "traffic", "vid_sweep.json"), encoding="utf-8") as f:
        mix = json.load(f)
    frames, rois = videos.make_video(mix, cell["image_hw"], 8, 2**31 + 43, cell["max_rois"], cuda)
    x = preprocess_images(torch.from_numpy(frames).to(cuda), port.config)
    rois = torch.from_numpy(rois).to(cuda)
    gaps = {}
    with torch.no_grad():
        s, d = port(x, rois)
        for side, lower in (("nominal", False), ("control", True)):
            ref = arch.reference(cell["detector"], Precisions.from_config(
                cell["precision"], arch.STAGES, lower=lower)).to(cuda).eval()
            ref.load_state_dict(state)
            rs, rd = ref(x, rois)
            gaps[side] = max(((s - rs).abs().max() / rs.abs().max()).item(),
                             ((d - rd).abs().max() / rd.abs().max()).item())
    assert gaps["nominal"] <= FORMAT_TOL < gaps["control"], gaps
