"""The trace reduction and every per-layer reader on a synthetic event list."""

import json
import os

import pytest

from portbench import architectures
from portbench.harness.trace import reduce_events
from portbench.run import read_metric
from portbench.yardstick import flops as yf
from portbench.yardstick import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MS = 1_000_000  # ns


class Ev:
    """A profiler event with the accessors the reduction reads."""

    def __init__(self, kind, name, start, end, corr=0, tid=1):
        self.kind, self.n, self.s, self.e, self.c, self.t = kind, name, start, end, corr, tid

    def is_user_annotation(self):
        return self.kind == "user_annotation"

    def device_type(self):
        return "DeviceType.CUDA" if self.kind == "kernel" else "DeviceType.CPU"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.c

    def start_thread_id(self):
        return self.t


def launch(name, at, dur, corr, tid=1):
    """A host launch at ``at`` ms and its kernel of ``dur`` ms 1 ms later."""
    return [Ev("cuda_runtime", "cudaLaunchKernel", at * MS, at * MS + 10, corr, tid),
            Ev("kernel", name, (at + 1) * MS, (at + 1 + dur) * MS, corr)]


def events(spans):
    """A 100 ms window; ``spans``: (name, start ms, end ms, [(kernel, at, dur)])."""
    ev = [Ev("user_annotation", "portbench.window", 0, 100 * MS)]
    corr = 0
    for name, s, e, kernels in spans:
        ev.append(Ev("user_annotation", name, s * MS, e * MS))
        for k, at, dur in kernels:
            corr += 1
            ev += launch(k, at, dur, corr)
    # a launch on another thread inside a span belongs to no span
    ev += launch("copy_kernel", 5, 1, 999, tid=2)
    return ev


def test_reduction():
    tr = reduce_events(events([("fused.detect", 0, 20, [("conv", 2, 4), ("gemm", 10, 2)]),
                               ("fused.seq_nms", 30, 90, [("amax", 40, 1)])]))
    assert tr["window_s"] == pytest.approx(0.1)
    assert tr["span_wall_s"] == pytest.approx({"fused.detect": 0.02, "fused.seq_nms": 0.06})
    assert tr["span_device_s"] == pytest.approx({"fused.detect": 0.006, "fused.seq_nms": 0.001})
    assert tr["busy_s"] == pytest.approx(0.007)  # the other thread's copy overlaps conv
    ops = dict(tr["breakdown"]["device_ops"])
    assert ops["conv"] == pytest.approx(0.004) and ops["copy_kernel"] == pytest.approx(0.001)
    gaps = dict(tr["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(0.1 - 0.007)
    assert gaps["fused.seq_nms"] > gaps["host"]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json"), encoding="utf-8") as f:
        return json.load(f)


def test_sweep_readers():
    spans = [("fused.detect", 0, 10, [("conv", 1, 2)]), ("fused.flow", 10, 20, [("flow", 11, 4)]),
             ("fused.nms_dedup", 20, 25, [("nms", 21, 1)]),
             ("fused.track_rounds", 25, 40, [("scan", 26, 5)]),
             ("fused.seq_nms", 40, 90, [("amax", 41, 2)])]
    c = _config("tcnn_fused_base")
    ctx = {"trace": reduce_events(events(spans)), "config": c, "peak_mem_bytes": 3 * 2**30,
           "videos": [{"t": 50, "tp": 64}], "window_frames": [50, 30], "window_s": 2.0}
    hw, rois = tuple(c["image_hw"]), c["max_rois"]
    got = {m["name"]: read_metric(m["name"], ctx) for m in _bench()["per_layer"]
           if m["name"].endswith(".sweep")}
    assert got["runner.tail_share.sweep"] == pytest.approx(10.0)
    assert got["link.seq_nms_share.sweep"] == pytest.approx(50.0)
    assert got["detect.device_ms_per_frame.sweep"] == pytest.approx(2.0 / 50)
    assert got["roofline.flow.sweep"] == pytest.approx(
        100 * work.fused_flow(64, hw, "fastest") / 0.004)
    assert got["roofline.nms_dedup.sweep"] == pytest.approx(
        100 * work.fused_nms_dedup(64, 192) / 0.001)
    assert got["roofline.track_rounds.sweep"] == pytest.approx(
        100 * work.fused_track_rounds(64, hw, c["tracker"], c["fused"]) / 0.005)
    arch = architectures.of(c)
    flops = sum(sum(yf.fused_dispatch_flops(arch, c["detector"], c["tracker"], c["fused"], t,
                                            rois).values()) for t in (50, 30))
    assert got["mfu.sweep"] == pytest.approx(100 * flops / (2.0 * yf.PEAK_BF16_FLOPS))
    assert got["idle.sweep"] == pytest.approx(100 * (1 - 0.015 / 0.1))
    assert got["peak_mem.sweep"] == 3.0
    for name in ("roofline.flow.sweep", "roofline.nms_dedup.sweep",
                 "roofline.track_rounds.sweep", "mfu.sweep"):
        assert 0 < got[name] < 100


def test_stream_readers_and_silence():
    spans = [("stream.detect", 0, 10, [("conv", 1, 2)]), ("stream.nms", 10, 12, [("nmsC", 10, 1)]),
             ("stream.mgp", 12, 20, [("flow", 13, 3)]), ("stream.mgp_nms", 20, 22, [("nmsB", 21, 1)]),
             ("stream.track_chunk", 22, 40, [("ncc", 23, 1)]),
             ("stream.backtrack", 40, 60, [("ncc", 41, 1)])]
    c = _config("tcnn_stream_base")
    per = 30
    ctx = {"trace": reduce_events(events(spans)), "config": c, "peak_mem_bytes": 2**30,
           "chunks_ms": [400.0, 420.0, 500.0], "traced_chunks_ms": [50.0, 30.0],
           "traced_chunk_sizes": [32, 5], "nms_valid": [3] * (37 * per),
           "mgp_valid": [9] * (37 * per), "window_frames": [37, 64], "window_s": 2.5}
    got = {m["name"]: read_metric(m["name"], ctx) for m in _bench()["per_layer"]
           if ".stream" in m["name"] or m["name"].startswith("stream.")}
    assert got["stream.chunk_ms_p50"] == 420.0
    assert got["stream.chunk_ms_p90"] == pytest.approx(484.0)
    assert got["track.share.stream"] == pytest.approx(100 * 0.038 / 0.08)
    hw, rois = tuple(c["image_hw"]), c["max_rois"]
    nms = (work.stream_nms(32, per, rois, [3] * 32 * per)
           + work.stream_nms(32, per, rois, [3] * 5 * per))
    assert got["roofline.nms.stream"] == pytest.approx(100 * nms / 0.001)
    mgp = (work.stream_mgp(32, hw, per, rois, "fastest", [9] * 32 * per)
           + work.stream_mgp(32, hw, per, rois, "fastest", [9] * 5 * per))
    assert got["roofline.mgp.stream"] == pytest.approx(100 * mgp / 0.004)
    chunk = sum(yf.stream_chunk_flops(architectures.of(c), c["detector"], c["tracker"], c["stream"],
                                      hw).values())
    assert got["mfu.stream"] == pytest.approx(100 * 3 * chunk / (1.32 * yf.PEAK_BF16_FLOPS))
    # 37 frames are two chunks, 64 two; each video links once at 900 slots
    link = yf.seq_nms_flops(37, 900, 30, 64) + yf.seq_nms_flops(64, 900, 30, 64)
    assert got["mfu.stream_window"] == pytest.approx(100 * (4 * chunk + link)
                                                     / (2.5 * yf.PEAK_BF16_FLOPS))
    assert got["idle.stream"] == pytest.approx(100 * (1 - 0.010 / 0.1))
    # a reader whose span never ran returns nothing, never 0
    ctx["trace"] = reduce_events(events([("stream.detect", 0, 10, [("conv", 1, 2)])]))
    for name in ("roofline.nms.stream", "roofline.mgp.stream", "track.share.stream"):
        assert read_metric(name, ctx) is None


@pytest.mark.parametrize("mix", ["vid_sweep", "vid_feed"])
def test_queue_keeps_the_mix_mean(mix):
    """The clipped pool's mean is the mix's mean, its lengths within the clip."""
    from portbench.harness.videos import queue_lengths

    with open(os.path.join(ROOT, "portbench", "traffic", mix + ".json"), encoding="utf-8") as f:
        m = json.load(f)
    lengths = queue_lengths(m)
    lo, hi = m["length"]["clip"]
    assert len(lengths) == m["length"]["pool"] and all(lo <= n <= hi for n in lengths)
    assert abs(sum(lengths) / len(lengths) - m["length"]["mean"]) <= 0.5


def test_fused_track_steps():
    """A stride-2 track anchored at an odd frame: its scan starts at the next
    sample, steps forward to its end and backward to the first frame."""
    import numpy as np

    from portbench.harness.compare import fused_track_steps

    T = 10
    boxes = np.arange(T * 4, dtype=np.float32).reshape(1, T, 4)
    conf = np.full((1, T), 0.8, np.float32)
    conf[0, 3] = conf[0, 4] = 1.0  # the anchor frame and its sample
    alive = np.ones((1, T), bool)
    alive[0, 8:] = False
    steps = fused_track_steps(boxes, conf, alive, 1, T, 2)
    assert [(s[0], s[2]) for s in steps] == [(2, 3), (2, 4), (2, 1), (2, 0)]
    assert steps[1][4] is None and np.array_equal(steps[0][3], boxes[0, 3])
    assert np.array_equal(steps[2][3], boxes[0, 3]) and steps[2][5] == pytest.approx(0.8)
