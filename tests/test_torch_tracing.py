"""Tracing of the port's two engines: the spans ``torch.profiler`` records
(the sweep's ``runner.*`` and ``fused.pipeline`` around the seven
``fused.<stage>`` spans; the stream's ``stream.<stage>``), the counters the
sweep and the stream return and log (``StageMetrics``, its
``VDETLIB_TPU_METRICS`` sink), and that a running profiler changes no
output.

The float32 tiny nets of tests/torch_fused_common.py at 96×128 (C = 4, R =
16): two in-memory videos of 12 and 20 frames through ``run_videos_fused``
at its default bucket, and one video of 20 frames in chunks of 8 through
``stream_video`` (tests/torch_stream_common.py), both engines. Spans on the
sweep's prefetch thread are recorded with ``profile_all_threads``, as
``utils/profiling.py::device_trace`` records them.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, record_function

import vdetlib_tpu_torch.pipeline.fused_runner as tfr
from tests.torch_fused_common import HW, C, R
from tests.torch_stream_common import CH, A, _chunks, _inputs, _opts, nets  # noqa: F401 (a fixture)
from vdetlib_tpu_torch.data.synth import SynthConfig, box_proto, make_video, vid_proto_in_memory
from vdetlib_tpu_torch.pipeline import runner as trunner
from vdetlib_tpu_torch.protos import proto_load
from vdetlib_tpu_torch.utils import profiling
from vdetlib_tpu_torch.video import detect as tdetect
from vdetlib_tpu_torch.video import link as tlink
from vdetlib_tpu_torch.video import mgp as tmgp
from vdetlib_tpu_torch.video import rescore as trescore
from vdetlib_tpu_torch.video import stream as tstream
from vdetlib_tpu_torch.video import track as ttrack

torch.set_num_threads(2)

LENGTHS = (12, 20)
MAX_PATHS = 64
FUSED_STAGES = ("fused.detect", "fused.flow", "fused.nms_dedup", "fused.track_features",
                "fused.track_rounds", "fused.rescore", "fused.seq_nms")
STREAM_SPANS = ("stream.detect", "stream.nms", "stream.mgp", "stream.mgp_nms",
                "stream.track_features", "stream.track_chunk", "stream.seed",
                "stream.backtrack", "stream.seq_nms")
SWEEP_COUNTERS = ("frames", "final_dets", "tubelets", "paths", "path_iters_live",
                  "path_iters_run")
STREAM_ARRAYS = ("boxes", "scores", "keep", "seq_scores", "path_ids")
T_STREAM = 20
MAIN = "test.main"


def _traced(fn):
    """``fn()`` under the profiler, every thread's spans recorded → (its
    result, [(name, start, end, thread)], the calling thread)."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with record_function(MAIN):
            out = fn()
    spans = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    main = next(t for n, _, _, t in spans if n == MAIN)
    return out, spans, main


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _path_count(path_ids):
    """Paths found a class lane, counted from the ids themselves (a lane's
    ids are 0..n-1, one an iteration)."""
    found = []
    for lane in path_ids:
        ids = sorted(set(lane[lane >= 0].tolist()))
        assert ids == list(range(len(ids)))
        found.append(len(ids))
    return found


@pytest.fixture(scope="module")
def cfg(nets):
    return trunner.PipelineConfig(
        detect=tdetect.DetectOptions(batch_size=4, max_rois=R, image_hw=HW, score_thresh=0.2),
        mgp=tmgp.MGPOptions(num_classes=C, max_boxes=24),
        track=ttrack.TrackOptions(max_tracks=8, anchors_per_round=4, batch_size=4, image_hw=HW,
                                  anchor_thresh=0.26),
        tracker_cfg=nets["tcfg"],
        rescore=trescore.RescoreOptions(num_classes=C, max_boxes=24, max_tracks=8),
        link=tlink.LinkOptions(num_classes=C, max_boxes=24, max_paths=MAX_PATHS),
    )


@pytest.fixture(scope="module")
def models(nets):
    return trunner.Models(nets["tdet"], nets["ttrk"])


@pytest.fixture(scope="module")
def entries():
    """(vid_proto, box_proto, frames) of the sweep's videos, in memory."""
    out = []
    for i, T in enumerate(LENGTHS):
        sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=C,
                                    seed=21 + i, proposals_per_frame=R), video=f"trace{i}")
        out.append((vid_proto_in_memory(sv), box_proto(sv), sv.frames))
    return out


@pytest.fixture(scope="module")
def sweeps(models, cfg, entries, tmp_path_factory):
    """The sweep without a profiler, then under one → (results, traced
    results, spans, the calling thread)."""
    work = tmp_path_factory.mktemp("sweeps")
    plain = tfr.run_videos_fused(str(work / "plain"), entries, models, cfg)
    traced, spans, main = _traced(
        lambda: tfr.run_videos_fused(str(work / "traced"), entries, models, cfg))
    return plain, traced, spans, main


@pytest.fixture(scope="module")
def streams(nets):
    """Each engine's stream without a profiler, its chunks' host outputs
    recorded as the track book receives them, then under one → {engine:
    (result, [(seeds taken, balive or None)], traced result, spans)}."""
    sv, rois = _inputs(T_STREAM, seed=8)
    out = {}
    for engine in tstream.ENGINES:
        chunks = []
        add_chunk = tstream._TrackBook.add_chunk

        def recording(book, o, seeds, *a, **k):
            chunks.append((len(seeds), o["balive"].copy() if "balive" in o else None))
            return add_chunk(book, o, seeds, *a, **k)

        opts = _opts(tstream, engine=engine)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tstream._TrackBook, "add_chunk", recording)
            res = tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"],
                                       _chunks(sv.frames), rois, opts)
        traced, spans, _ = _traced(lambda: tstream.stream_video(
            nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames), rois, opts))
        out[engine] = (res, chunks, traced, spans)
    return out


def test_runner_load_runs_on_the_prefetch_thread(sweeps):
    _, _, spans, main = sweeps
    loads = _named(spans, "runner.load")
    assert len(loads) == len(LENGTHS)
    assert all(t != main for _, _, _, t in loads)


@pytest.mark.parametrize("name", ["runner.wait", "fused.pipeline", "runner.protos",
                                  "runner.write"])
def test_runner_spans_run_on_the_calling_thread(sweeps, name):
    _, _, spans, main = sweeps
    got = _named(spans, name)
    assert len(got) == len(LENGTHS) and all(t == main for _, _, _, t in got)


@pytest.mark.parametrize("stage", FUSED_STAGES)
def test_fused_stages_nest_in_the_pipeline_span(sweeps, stage):
    _, _, spans, main = sweeps
    parents = _named(spans, "fused.pipeline")
    got = _named(spans, stage)
    assert len(got) >= len(LENGTHS)
    for _, s, e, t in got:
        assert t == main and any(ps <= s and e <= pe for _, ps, pe, _ in parents)


@pytest.mark.parametrize("engine", tstream.ENGINES)
def test_stream_emits_its_spans(streams, engine):
    _, _, _, spans = streams[engine]
    names = {n for n, _, _, _ in spans}
    assert set(STREAM_SPANS) <= names
    assert not any(n.startswith(("runner.", "fused.")) for n in names)


def test_sweep_counters_match_the_path_ids(sweeps, models, cfg, entries):
    """Each video's counters against its pipeline output's path ids and its
    written protos; the paths found are fewer than the iterations run."""
    plain, _, _, _ = sweeps
    engine = tfr.FusedEngine(models, cfg)
    for (vid, box, frames), res in zip(entries, plain):
        loaded = engine.load(vid, box, frames)
        out = engine.pipe(loaded.frames, loaded.rois, loaded.t_valid, loaded.mask)
        found = _path_count(out.path_ids[:, :loaded.t_valid].numpy())
        want = {"frames": len(frames),
                "final_dets": len(proto_load(res["final"])["detections"]),
                "tubelets": len(proto_load(res["tubelets"])["tracks"]),
                "paths": sum(found), "path_iters_live": max(found),
                "path_iters_run": MAX_PATHS}
        assert res["counters"] == want
        assert 0 < want["path_iters_live"] < MAX_PATHS


@pytest.mark.parametrize("engine", tstream.ENGINES)
def test_stream_counters_match_a_recount(streams, engine):
    """The stream's counters against its chunks' seeds and backtrack lanes
    and its path ids; the engines agree on everything but the backtracks
    run (the host engine backtracks only the chunks that seed)."""
    res, chunks, _, _ = streams[engine]
    ran = [b for _, b in chunks if b is not None]
    found = _path_count(res["path_ids"])
    want = {"frames": T_STREAM, "tracks": len(res["tracks"]), "chunks": len(chunks),
            "seeds": sum(n for n, _ in chunks), "seed_steps": A * len(chunks),
            "backtrack_live": int(sum((b > 0.5).sum() for b in ran)),
            "backtrack_run": sum(b.size for b in ran),
            "paths": sum(found), "path_iters_live": max(found),
            "path_iters_run": _opts(tstream).max_paths}
    got = res["metrics"]
    assert got["stage"] == "stream" and {k: got[k] for k in want} == want
    assert want["seeds"] > 0 and want["backtrack_live"] > 0
    fused, host = (streams[e][0]["metrics"] for e in ("fused", "host"))
    for k in ("seeds", "backtrack_live", "paths", "path_iters_live"):
        assert fused[k] == host[k], k
    assert host["backtrack_run"] <= fused["backtrack_run"] == fused["chunks"] * A * 2 * CH


def test_metrics_sink_carries_the_counters(nets, models, cfg, entries, tmp_path, monkeypatch):
    sink = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("VDETLIB_TPU_METRICS", str(sink))
    res = tfr.run_videos_fused(str(tmp_path / "sweep"), entries, models, cfg)
    sv, rois = _inputs(T_STREAM, seed=8)
    sres = tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames),
                                rois, _opts(tstream))
    records = {r["stage"]: r for r in map(json.loads, sink.read_text().splitlines())}
    sweep = records["pipeline_fused"]
    assert sweep["videos"] == len(entries) and sweep["prefetch_wait_s"] >= 0.0
    for k in SWEEP_COUNTERS:
        assert sweep[k] == sum(r["counters"][k] for r in res), k
    assert records["stream"] == json.loads(json.dumps(sres["metrics"]))


@pytest.mark.parametrize("engine", ["sweep"] + list(tstream.ENGINES))
def test_outputs_identical_under_a_profiler(sweeps, streams, engine):
    if engine == "sweep":
        plain, traced, _, _ = sweeps
        for a, b in zip(plain, traced):
            for k in ("final", "tubelets"):
                with open(a[k], "rb") as fa, open(b[k], "rb") as fb:
                    assert fa.read() == fb.read(), k
            assert a["counters"] == b["counters"]
        return
    res, _, traced, _ = streams[engine]
    for k in STREAM_ARRAYS:
        np.testing.assert_array_equal(res[k], traced[k], err_msg=k)
    assert sorted(res["tracks"]) == sorted(traced["tracks"])
    for tid, seg in res["tracks"].items():
        for (t, b, s), (t2, b2, s2) in zip(seg, traced["tracks"][tid], strict=True):
            assert t == t2 and s == s2 and np.array_equal(b, b2)
    timed = ("wall_s", "frames_per_sec")
    assert ({k: v for k, v in res["metrics"].items() if k not in timed}
            == {k: v for k, v in traced["metrics"].items() if k not in timed})


def test_device_trace_records_the_prefetch_thread(models, cfg, entries, tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        tfr.run_videos_fused(str(tmp_path / "work"), entries[:1], models, cfg)
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())["traceEvents"]
    tids = {name: {e["tid"] for e in events if e.get("name") == name}
            for name in ("runner.load", "runner.wait", "fused.pipeline")}
    assert tids["runner.load"] and tids["runner.wait"] == tids["fused.pipeline"]
    assert not tids["runner.load"] & tids["runner.wait"]
