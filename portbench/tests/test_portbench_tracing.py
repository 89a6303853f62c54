"""The readers of the program's runner and pipeline spans on a synthetic
trace, and every earlier sweep reader unchanged when those spans are in it."""

import pytest
from test_portbench_metrics import _bench, _config, events  # the sibling's synthetic trace

from portbench.harness.trace import reduce_events
from portbench.run import read_metric

STAGES = [("fused.detect", 1, 10, [("conv", 1, 2)]), ("fused.flow", 10, 20, [("flow", 11, 4)]),
          ("fused.nms_dedup", 20, 25, [("nms", 21, 1)]),
          ("fused.track_rounds", 25, 40, [("scan", 26, 5)]),
          ("fused.seq_nms", 40, 90, [("amax", 41, 2), ("amax", 88, 1)])]
# the pipeline's span around its stages with 3 ms of glue, then the runner's
# parts; a launch in the glue and one in the read-back
PROGRAM = [("fused.pipeline", 0, 92, [("pack", 91, 1)]),
           ("runner.protos", 92, 96, [("copy", 95, 1)]), ("runner.write", 96, 99, [])]
NEW = ("runner.protos_share.sweep", "runner.write_share.sweep", "fused.glue_share.sweep")


def _ctx(with_spans=True):
    """The synthetic sweep; without the program's new spans, the same device
    work as a program without them (the parent's) traces it."""
    ev = events(STAGES + PROGRAM)
    if not with_spans:
        new = {name for name, _, _, _ in PROGRAM}
        ev = [e for e in ev if not (e.is_user_annotation() and e.name() in new)]
    return {"trace": reduce_events(ev), "config": _config("tcnn_fused_base"),
            "peak_mem_bytes": 3 * 2**30, "videos": [{"t": 50, "tp": 64}],
            "window_frames": [50, 30], "window_s": 2.0}


def _sweep_metrics():
    return [m["name"] for m in _bench()["per_layer"] if m["name"].endswith(".sweep")]


@pytest.mark.parametrize("name, value", [("runner.protos_share.sweep", 4.0),
                                         ("runner.write_share.sweep", 3.0),
                                         ("fused.glue_share.sweep", 3.0)])
def test_span_readers(name, value):
    assert read_metric(name, _ctx()) == pytest.approx(value)
    # a program without the span (the parent's) reads nothing, never 0
    assert read_metric(name, _ctx(with_spans=False)) is None


def test_earlier_readers_read_the_same_with_the_new_spans():
    old = [n for n in _sweep_metrics() if n not in NEW]
    before = {n: read_metric(n, _ctx(with_spans=False)) for n in old}
    after = {n: read_metric(n, _ctx()) for n in old}
    assert after == before
    assert before["runner.tail_share.sweep"] == pytest.approx(11.0)
    assert before["link.seq_nms_share.sweep"] == pytest.approx(50.0)
    assert before["detect.device_ms_per_frame.sweep"] == pytest.approx(2.0 / 50)
    assert before["idle.sweep"] == pytest.approx(82.0)  # the other thread's copy included


def test_idle_gaps_move_from_the_host_to_the_spans():
    before = dict(_ctx(with_spans=False)["trace"]["breakdown"]["idle_gaps"])
    after = dict(_ctx()["trace"]["breakdown"]["idle_gaps"])
    assert before["host"] == pytest.approx(0.008)
    assert "host" not in after
    assert after["fused.pipeline"] == pytest.approx(0.002)
    assert after["runner.protos"] == pytest.approx(0.003)
    assert after["runner.write"] == pytest.approx(0.003)
    assert {k: v for k, v in after.items() if not k.startswith(("runner.", "fused.pipeline"))} \
        == pytest.approx({k: v for k, v in before.items() if k != "host"})
