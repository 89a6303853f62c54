"""Port parity: the stream with EMA templates (``TrackerConfig.template_eta``
> 0), both engines, at ``track_stride`` 1 and 2.

The tiny float32 models and inputs of tests/torch_stream_common.py, the
same in JAX and in the port, with ``template_eta`` 0.1 and an update
threshold of 0.3 (the tiny nets' peaks lie around it, so some steps adapt
and some do not). Bounds:

- the port's two engines equal each other bit for bit (keep, boxes,
  scores, path ids, seq-scores, every segment's frames, boxes and scores),
  as tests/test_stream.py requires of the JAX engines and as
  tests/test_torch_stream_stride.py holds without EMA;
- each engine against JAX's fused engine (JAX's two engines are equal bit
  for bit, its own tests): the cross-compilation bound of
  ``__graft_entry__.py:271-291`` (keep exact, boxes 0.5 px, scores 0.01,
  path ids < 1% of slots, segments on the same frames);
- the adapted templates change the tracks (a precondition: the run with
  eta 0 differs).
"""

import dataclasses

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the other stream tests)
import numpy as np
import pytest
import torch

from tests.torch_stream_common import (  # noqa: F401  (nets: a fixture)
    _assert_bit_equal,
    _chunks,
    _compare_results,
    _inputs,
    _opts,
    nets,
)
from vdetlib_tpu.video import stream as jstream
from vdetlib_tpu_torch.video import stream as tstream

torch.set_num_threads(2)

T = 20  # 2.5 chunks: the last one is partial
EMA = dict(template_eta=0.1, template_update_conf=0.3)


@pytest.fixture(scope="module")
def ema_runs(nets):
    """stride → (JAX fused result, {engine: port result}, the port's eta-0
    run), each stride run once for the module."""
    cache = {}

    def run(stride):
        if stride not in cache:
            sv, rois = _inputs(T, seed=8)
            jcfg = dataclasses.replace(nets["jcfg"], **EMA)
            tcfg = dataclasses.replace(nets["tcfg"], **EMA)
            want = jstream.stream_video(nets["jdet"], nets["jdp"], nets["jtrk"], nets["jtp"],
                                        jcfg, _chunks(sv.frames), rois,
                                        _opts(jstream, engine="fused", track_stride=stride))
            got = {engine: tstream.stream_video(
                nets["tdet"], nets["ttrk"], tcfg, _chunks(sv.frames), rois,
                _opts(tstream, engine=engine, track_stride=stride))
                for engine in ("fused", "host")}
            frozen = tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"],
                                          _chunks(sv.frames), rois,
                                          _opts(tstream, track_stride=stride))
            cache[stride] = want, got, frozen
        return cache[stride]

    return run


@pytest.mark.parametrize("stride", [1, 2])
def test_ema_stream_engines_equal_bit_for_bit(ema_runs, stride):
    _, got, frozen = ema_runs(stride)
    _assert_bit_equal(got["fused"], got["host"])
    segs = lambda r: {k: np.stack([b for _, b, _ in v]) for k, v in r["tracks"].items()}  # noqa: E731
    a, b = segs(got["fused"]), segs(frozen)
    assert len(a) > 0
    assert set(a) != set(b) or any(a[k].shape != b[k].shape or np.abs(a[k] - b[k]).max() > 1e-3
                                   for k in a), "the EMA changed no track"


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("engine", ["fused", "host"])
def test_ema_stream_matches_jax(ema_runs, engine, stride):
    want, got, _ = ema_runs(stride)
    assert len(want["tracks"]) > 0 and (want["path_ids"] >= 0).any()
    _compare_results(got[engine], want)
