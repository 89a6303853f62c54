"""Port parity: the streaming engine (fused, stride 1) against the JAX one.

Same frames, proposals and converted weights through
``vdetlib_tpu.video.stream`` and ``vdetlib_tpu_torch.video.stream`` at the
tiny preset (96×128, R=16, C=4, 6 track slots, chunk 8), detector and
tracker in float32 (at bf16 the two frameworks round at other places; see
tests/test_torch_fused.py).

- ``_mgp_chunk``: scores and valid bits exact; boxes within the MGP
  box-shift tolerance (mean < 0.05 px, max < 0.5 px — the flow differs at
  bf16 level, tests/test_torch_flow.py).
- ``track_chunk``: one ``ncc_update`` step on identical inputs, boxes to
  1e-3 px and confidence to 1e-4, alive bits exact (the rollout is chaotic,
  so it is pinned per step).
- ``backtrack_seeds``: alive bits exact, boxes within 0.5 px over an
  8-frame window.
- One chunk of ``make_stream_chunk_fn`` fed the JAX detection outputs:
  discrete fields (keep, seed slots / frames / ok, alive bits) exact, floats
  within the bounds below.
- ``stream_video`` end to end over 2.5 chunks, ``stream_to_protos`` and the
  CLI with ``--device cpu``: the cross-compilation bound of
  ``__graft_entry__.py:271-291`` as tests/test_torch_fused.py uses it —
  keep bits exact, boxes within 0.5 px, scores within 0.01, path ids
  differing on < 1% of slots; track segments cover the same frames.

The host engine and ``track_stride`` 2: tests/test_torch_stream_stride.py.

Against the parity tests' blind spots, the fixtures assert that roi
counts and slot layouts vary from frame to frame, and that the run seeds in
several chunks, crosses chunk boundaries and backtracks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_stream_common import (  # noqa: F401  (nets: a fixture)
    A,
    C,
    CH,
    HW,
    R,
    TOL_SCORE,
    _chunks,
    _close_boxes,
    _compare_protos,
    _compare_results,
    _inputs,
    _opts,
    _preconditions,
    _run_clis,
    _t,
    nets,
)
from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.video import stream as jstream
from vdetlib_tpu.video.detect import _detect_step as j_detect_step
from vdetlib_tpu.video.track import tracker_features as j_tracker_features
from vdetlib_tpu_torch.video import stream as tstream

torch.set_num_threads(2)

T = 20  # 2.5 chunks: the last one is partial


# ------------------------------------------------------------------ pieces


def test_mgp_chunk_matches_jax():
    sv, rois = _inputs(CH + 1, seed=3)
    rng = np.random.default_rng(0)
    scores = rng.uniform(0, 1, (CH, C - 1, R)).astype(np.float32)
    keep = rng.uniform(size=(CH, C - 1, R)) > 0.5
    prev = (rois[0], scores[0] * 0.5, ~keep[0])
    args = (sv.frames, rois[1:], scores, keep) + prev
    want = jstream._mgp_chunk(*(jnp.asarray(a) for a in args), 0.9, preset="fastest")
    got = tstream._mgp_chunk(*(_t(a) for a in args), 0.9, preset="fastest")
    (wb, ws, wv), (gb, gs, gv) = [np.asarray(x) for x in want], [x.numpy() for x in got]
    assert gb.shape == wb.shape == (CH, 3 * R, 4)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gs, ws)
    d = np.abs(gb - wb)
    assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())
    assert np.abs(wb[:, R:2 * R] - rois[:CH]).max() > 0.1  # the forward hop moved boxes


@pytest.fixture(scope="module")
def feats(nets):
    sv, _ = _inputs(2 * CH, seed=4)
    return sv, np.asarray(j_tracker_features(nets["jtrk"], nets["jtp"], jnp.asarray(sv.frames)))


def test_track_chunk_one_step_matches_jax(nets, feats):
    sv, f = feats
    K = sv.gt_boxes.shape[0]
    boxes0 = np.zeros((A, 4), np.float32)
    boxes0[:K] = sv.gt_boxes[:, 0]
    alive0 = np.arange(A) < K
    tpl = np.asarray(jax.vmap(lambda b: jtn.extract_template(jnp.asarray(f[0]), b, nets["jcfg"]))(
        jnp.asarray(boxes0)))
    want = jstream.track_chunk(nets["jcfg"], jnp.asarray(f[1:2]), jnp.asarray(tpl),
                               jnp.asarray(boxes0), jnp.asarray(alive0), 0.3)
    with torch.no_grad():
        got = tstream.track_chunk(nets["tcfg"], _t(f[1:2]), _t(tpl), _t(boxes0), _t(alive0), 0.3)
    wb, wc, wa, wbe, wae, _ = (np.asarray(x) for x in want)
    gb, gc, ga, gbe, gae, _ = (x.numpy() for x in got)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gae, wae)
    assert wa[:K].all() and not wa[K:].any()
    np.testing.assert_allclose(gb, wb, atol=1e-3, rtol=0)
    np.testing.assert_allclose(gbe, wbe, atol=1e-3, rtol=0)
    np.testing.assert_allclose(gc, wc, atol=1e-4, rtol=0)


def test_backtrack_seeds_matches_jax(nets, feats):
    sv, f = feats
    K = sv.gt_boxes.shape[0]
    anchor_ts = np.array([CH + 3, CH, 2 * CH - 1, 5, 0, CH + 2][:A], np.int32)
    seeded = np.array([True] * K + [False] * (A - K))
    anchor_boxes = np.stack([sv.gt_boxes[k % K, anchor_ts[k]] for k in range(A)]).astype(np.float32)
    tpl = np.asarray(jax.vmap(
        lambda t, b: jtn.extract_template(jnp.asarray(f)[t], b, nets["jcfg"]))(
        jnp.asarray(anchor_ts), jnp.asarray(anchor_boxes)))
    args = (f, anchor_ts, anchor_boxes, tpl, seeded)
    wb, wa = (np.asarray(x) for x in jstream.backtrack_seeds(
        nets["jcfg"], *(jnp.asarray(a) for a in args), 0.3))
    with torch.no_grad():
        gb, ga = (x.numpy() for x in tstream.backtrack_seeds(
            nets["tcfg"], *(_t(a) for a in args[:1]), _t(anchor_ts.astype(np.int64)),
            *(_t(a) for a in args[2:]), 0.3))
    np.testing.assert_array_equal(ga, wa)
    assert wa.sum() > K and not wa[K:].any()
    _close_boxes(gb, wb, wa)


# ------------------------------------------------------------------ one chunk, teacher-forced


def _jax_carry(nets, feat_shape, a):
    P, Cf = nets["jcfg"].template_pool, nets["jcfg"].out_features
    return (jnp.zeros((a, P, P, Cf)), jnp.zeros((a, 4)), jnp.zeros((a,), bool),
            jnp.zeros((R, 4)), jnp.zeros((C - 1, R)), jnp.zeros((C - 1, R), bool),
            jnp.zeros(feat_shape, jnp.float32), jnp.asarray(False), jnp.zeros((a, 4)),
            jnp.zeros((a,)), jnp.zeros((a,), bool))


def test_stream_chunk_fed_jax_detections_matches_jax(nets, monkeypatch):
    """Two chunks of the step program (the second carries state, seeds and
    backtracks), the JAX detection outputs fed to both sides."""
    sv, rois = _inputs(2 * CH, seed=12)
    probs, boxes = (np.asarray(x) for x in j_detect_step(
        nets["jdet"], nets["jdp"], jnp.asarray(sv.frames), jnp.asarray(rois), True))
    table = jnp.asarray(rois)

    def j_teacher(model, params, images_u8, rois_b, regress, net_hw=None):
        t = jnp.argmin(jnp.abs(rois_b[:, None] - table[None]).sum((2, 3)), axis=1)
        return jnp.asarray(probs)[t], jnp.asarray(boxes)[t]

    def t_teacher(model, images_u8, rois_b, regress=True, net_hw=None):
        t = torch.argmin((rois_b[:, None] - _t(rois)[None]).abs().sum((2, 3)), dim=1)
        return _t(probs)[t], _t(boxes)[t]

    monkeypatch.setattr(jstream, "_detect_step", j_teacher)
    monkeypatch.setattr(tstream, "_detect_step", t_teacher)
    # more slots than the first chunk fills, so the second chunk seeds too
    kw = dict(track_slots=2 * A, seed_thresh=0.4)
    jstep, junpack = jstream.make_stream_chunk_fn(nets["jdet"], nets["jtrk"], nets["jcfg"],
                                                  _opts(jstream, **kw))
    tstep, tunpack = tstream.make_stream_chunk_fn(nets["tdet"], nets["ttrk"], nets["tcfg"],
                                                  _opts(tstream, **kw))
    jcarry = _jax_carry(nets, (CH, HW[0] // 4, HW[1] // 4, nets["jcfg"].out_features), 2 * A)
    tcarry = tstream.init_carry(_opts(tstream, **kw), nets["tcfg"], torch.device("cpu"))
    jhalo, thalo = jnp.asarray(sv.frames[0]), _t(sv.frames[0])
    n_seeds, backtracked = [], []
    for c in range(2):
        fr, ro = sv.frames[c * CH:(c + 1) * CH], rois[c * CH:(c + 1) * CH]
        jcarry, jhalo, jp = jstep(nets["jdp"], nets["jtp"], jnp.asarray(fr), jnp.asarray(ro),
                                  jnp.int32(CH), jhalo, jcarry)
        tcarry, thalo, tp = tstep(_t(fr), _t(ro), CH, thalo, tcarry)
        want, got = junpack(np.asarray(jp)), tunpack(tp.numpy())
        for name in ("out_keep", "ta", "seed_slot", "seed_ti", "seed_ok", "balive"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(got["out_scores"], want["out_scores"])
        np.testing.assert_allclose(got["seed_score"], want["seed_score"], atol=0, rtol=0)
        _close_boxes(got["out_boxes"], want["out_boxes"])
        _close_boxes(got["seed_box"], want["seed_box"])
        _close_boxes(got["tb"], want["tb"], want["ta"] > 0.5)
        _close_boxes(got["bb"], want["bb"], want["balive"] > 0.5)
        np.testing.assert_allclose(got["tc"], want["tc"], atol=TOL_SCORE, rtol=0)
        n_seeds.append(int(want["seed_ok"].sum()))
        backtracked.append(bool((want["balive"] > 0.5).any()))
    # the case is hard enough: seeds in both chunks, carried slots alive in
    # the second, and the kept slot layout varies from frame to frame
    assert all(n > 0 for n in n_seeds) and any(backtracked), (n_seeds, backtracked)
    assert (want["ta"] > 0.5).any()
    kept = (want["out_keep"] > 0.5).any(1)
    assert len({tuple(np.nonzero(k)[0]) for k in kept}) > 1
    assert len({int((r != 0).any(-1).sum()) for r in rois}) > 1, "roi counts do not vary"


# ------------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def runs(nets):
    sv, rois = _inputs(T, seed=8)
    want = jstream.stream_video(nets["jdet"], nets["jdp"], nets["jtrk"], nets["jtp"],
                                nets["jcfg"], _chunks(sv.frames), rois, _opts(jstream))
    got = tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames),
                               rois, _opts(tstream))
    return sv, rois, want, got


def test_stream_video_end_to_end_matches_jax(runs):
    sv, rois, want, got = runs
    _preconditions(want, rois)
    _compare_results(got, want)


def test_stream_to_protos_matches_jax(runs):
    sv, rois, want, got = runs
    fids = list(range(1, T + 1))
    jd, jt, jk = jstream.stream_to_protos(want, fids, "v")
    td, tt, tk = tstream.stream_to_protos(got, fids, "v")
    _compare_protos(td, jd, tt, jt, tk, jk)


@pytest.mark.parametrize("kw, exc", [
    (dict(track_stride=3), ValueError),  # the JAX engines take strides 1 and 2
    (dict(chunk=7, track_stride=2), ValueError),  # a chunk the stride does not divide
    (dict(engine="nope"), ValueError),
])
@pytest.mark.parametrize("engine", ["fused", "host"])
def test_unported_options_raise(nets, engine, kw, exc):
    """Options the JAX engines refuse too (EMA templates run: see
    tests/test_torch_stream_ema.py)."""
    with pytest.raises(exc):
        tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], iter(()), None,
                             _opts(tstream, **{"engine": engine, **kw}))


def test_stream_cli_matches_jax_cli(nets, tmp_path, monkeypatch):
    """Both tools read the same JPEG frames and proposals; their random
    weights are replaced by the same converted float32 weights."""
    import vdetlib_tpu_torch.cli.stream as tcli

    argv, (jd, jt, jk), (td, tt, tk) = _run_clis(nets, tmp_path, monkeypatch, T)
    _compare_protos(td, jd, tt, jt, tk, jk)
    assert len(jk["tracks"]) > 0
    # the weight flags load checkpoints into the tool's models (here their own weights)
    from vdetlib_tpu_torch.pipeline.checkpoint import save_params
    from vdetlib_tpu_torch.protos import proto_load

    save_params(str(tmp_path / "det.pt"), nets["tdet"])
    save_params(str(tmp_path / "trk.pt"), nets["ttrk"])
    assert tcli.main(argv[:1] + [str(tmp_path / "t2")] + argv[1:]
                     + ["--device", "cpu", "--detector_weights", str(tmp_path / "det.pt"),
                        "--tracker_weights", str(tmp_path / "trk.pt")]) == 0
    for name, want in zip(("final.json", "tubelets.json", "track.json"), (td, tt, tk)):
        assert proto_load(str(tmp_path / "t2" / "clip" / name)) == want, name
