"""Port parity: the stream's host engine and ``track_stride`` 2.

The tiny float32 models and inputs of tests/torch_stream_common.py, the
same in JAX and in the port. Tolerances, each stated where it is checked:

- ``track_chunk_strided`` on teacher-forced scan samples (the scan replaced
  by the same sample arrays on both sides): every output bit-exact, since
  the upsampling and the boundary fill compute in float32 as JAX does; the
  whole function on real features over 4 samples: alive bits exact, boxes
  within 0.05 px (the rollout differs by 0.010-0.021 px at 4 samples; one
  step is pinned to 1e-3 px by tests/test_torch_stream.py), conf and the
  boundary fill within 1e-3;
- ``_snap_sample`` and ``_backtrack_entries_strided``: exact;
- torch host == torch fused: bit-exact (keep, boxes, scores, path ids,
  seq-scores, and every segment's frames, boxes and scores), at stride 1
  and 2, as tests/test_stream.py requires of the JAX engines;
- torch against JAX at stride 2, end to end and through the CLI: the
  cross-compilation bound (keep exact, boxes 0.5 px, scores 0.01, path ids
  < 1% of slots, segments on the same frames).

The three reference faults of ROADMAP.md Queue 3 are reproduced, not
fixed, each by a named test: ``test_reference_fault_no_tc_valid_clamp``
(``vdetlib_tpu/video/stream.py:209``),
``test_reference_fault_backtrack_snaps_with_option_chunk`` (``:917``) and
``test_reference_fault_fresh_seed_has_no_forward_entries`` (``:271``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_stream_common import (  # noqa: F401  (nets: a fixture)
    A,
    CH,
    R,
    _assert_bit_equal,
    _chunks,
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
from vdetlib_tpu.video.track import tracker_features as j_tracker_features
from vdetlib_tpu_torch.video import stream as tstream

torch.set_num_threads(2)

S = 2  # the stride under test
TS = CH // S  # samples a chunk


# ------------------------------------------------------------------ pieces


def _sample_state(nets, valid):
    """The JAX features of one chunk's samples (the chunk padded after
    ``valid`` real frames, as the engines pad), slot templates and state
    entering the chunk, and a boundary snapshot."""
    sv, _ = _inputs(2 * CH, seed=4)
    frames = sv.frames[CH:].copy()
    frames[valid:] = frames[valid - 1]
    feats = np.asarray(j_tracker_features(nets["jtrk"], nets["jtp"], jnp.asarray(frames[::S])))
    f0 = j_tracker_features(nets["jtrk"], nets["jtp"], jnp.asarray(sv.frames[:1]))[0]
    K = sv.gt_boxes.shape[0]
    boxes0 = np.zeros((A, 4), np.float32)
    boxes0[:K] = sv.gt_boxes[:, CH - 1]
    tpl_boxes = np.zeros((A, 4), np.float32)
    tpl_boxes[:K] = sv.gt_boxes[:, 0]
    tpl = np.asarray(jax.vmap(lambda b: jtn.extract_template(f0, b, nets["jcfg"]))(
        jnp.asarray(tpl_boxes)))
    rng = np.random.default_rng(1)
    bnd = ((boxes0 + rng.normal(0, 2, (A, 4))).astype(np.float32),
           rng.uniform(0.3, 1, A).astype(np.float32), np.arange(A) % 2 == 0)
    return K, (feats, tpl, boxes0, np.arange(A) < K) + bnd


@pytest.mark.parametrize("valid", [CH, 4], ids=["full", "partial"])
def test_track_chunk_strided_matches_jax(nets, valid):
    K, args = _sample_state(nets, valid)
    want = [np.asarray(x) for x in jstream.track_chunk_strided(
        nets["jcfg"], *(jnp.asarray(a) for a in args), 0.3, S, CH)]
    with torch.no_grad():
        got = [x.numpy() for x in tstream.track_chunk_strided(
            nets["tcfg"], *(_t(a) for a in args), 0.3, S, CH)]
    names = ("boxes", "conf", "alive", "box_end", "conf_end", "alive_end", "templates_end",
             "bfill_box", "bfill_conf", "bfill_alive")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("boxes", "box_end"):
            np.testing.assert_allclose(g, w, atol=0.05, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0, err_msg=name)
    assert want[2][:K].all() and not want[2][K:].any()  # the carried slots live throughout
    assert want[9].any() and not want[9].all()  # the fill is gated by the snapshot


def _teacher_samples(monkeypatch, seed=0):
    """Replace the scan of both ``track_chunk_strided`` with the same
    sample arrays: random boxes, conf and alive bits at TS samples."""
    rng = np.random.default_rng(seed)
    boxes_s = rng.uniform(0, 120, (A, TS, 4)).astype(np.float32)
    conf_s = rng.uniform(0, 1, (A, TS)).astype(np.float32)
    alive_s = rng.uniform(size=(A, TS)) < 0.7
    samples = (boxes_s, conf_s, alive_s, boxes_s[:, -1], alive_s[:, -1])

    def jscan(cfg, feats, templates, *_):
        return tuple(jnp.asarray(x) for x in samples) + (templates,)

    def tscan(cfg, feats, templates, *_):
        return tuple(_t(x) for x in samples) + (templates,)

    monkeypatch.setattr(jstream, "track_chunk", jscan)
    monkeypatch.setattr(tstream, "track_chunk", tscan)
    bnd = (rng.uniform(0, 120, (A, 4)).astype(np.float32),
           rng.uniform(0, 1, A).astype(np.float32), rng.uniform(size=A) < 0.5)
    rest = (np.zeros((TS, 2, 2, 1), np.float32), np.zeros((A, 1, 1, 1), np.float32),
            np.zeros((A, 4), np.float32), np.zeros(A, bool)) + bnd
    return samples, rest


def _strided_both(nets, rest):
    # the JAX function's Python body, so that the teacher replaces its scan
    want = [np.asarray(x) for x in jstream.track_chunk_strided.__wrapped__(
        nets["jcfg"], *(jnp.asarray(a) for a in rest), 0.3, S, CH)]
    got = [x.numpy() for x in tstream.track_chunk_strided(
        nets["tcfg"], *(_t(a) for a in rest), 0.3, S, CH)]
    return got, want


def test_track_chunk_strided_upsampling_is_bit_exact(nets, monkeypatch):
    """On the same scan samples the upsampled frames, the scan-end carry
    and the boundary fill equal JAX's to the last bit; skipped interior
    frames are midpoints, alive where both samples are."""
    (boxes_s, _, alive_s, _, _), rest = _teacher_samples(monkeypatch)
    got, want = _strided_both(nets, rest)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    boxes, alive = got[0], got[2]
    np.testing.assert_array_equal(boxes[:, ::S], boxes_s)
    np.testing.assert_array_equal(alive[:, 1:-1:S], alive_s[:, :-1] & alive_s[:, 1:])
    np.testing.assert_array_equal(boxes[:, -1], boxes_s[:, -1])  # the trailing frame holds


def test_reference_fault_no_tc_valid_clamp(nets, monkeypatch):
    """JAX ``stream.py:209``, reproduced: with no ``tc_valid`` clamp, the
    frame after a partial chunk's last real sample interpolates toward the
    next, padded sample instead of holding the real one — on teacher-forced
    samples (exactly) and on real features of a chunk padded after 4
    frames (by 0.5 px or more)."""
    (boxes_s, _, _, _, _), rest = _teacher_samples(monkeypatch, seed=1)
    got, want = _strided_both(nets, rest)
    last = (4 - 1) // S  # the last real sample of a chunk of 4 real frames
    t = S * last + 1  # frame 3, past the last real frame
    mid = (1.0 - np.float32(0.5)) * boxes_s[:, last] + np.float32(0.5) * boxes_s[:, last + 1]
    np.testing.assert_array_equal(got[0][:, t], mid)
    np.testing.assert_array_equal(want[0][:, t], mid)
    assert not np.array_equal(got[0][:, t], boxes_s[:, last])

    monkeypatch.undo()
    K, args = _sample_state(nets, 4)
    with torch.no_grad():
        boxes = tstream.track_chunk_strided(nets["tcfg"], *(_t(a) for a in args), 0.3, S, CH)[0]
        samples = tstream.track_chunk(nets["tcfg"], *(_t(a) for a in args[:4]), 0.3)[0]
    assert np.abs(boxes[:K, t].numpy() - samples[:K, last].numpy()).max() > 0.5


def test_snap_sample_matches_jax():
    for tc_valid in range(1, CH + 1):
        want = [jstream._snap_sample(ti, tc_valid, S) for ti in range(CH)]
        got = [tstream._snap_sample(ti, tc_valid, S) for ti in range(CH)]
        assert got == want, tc_valid
        got_t = tstream._snap_sample(torch.arange(CH), tc_valid, S)
        assert got_t.tolist() == want, tc_valid
        want_j = jstream._snap_sample(jnp.arange(CH), jnp.int32(tc_valid), S)
        assert np.asarray(want_j).tolist() == want, tc_valid


def _entries_equal(got, want):
    assert [g for g, _, _ in got] == [g for g, _, _ in want]
    for (_, gb, gs), (_, wb, ws) in zip(got, want):
        assert gb.dtype == wb.dtype == np.float32
        np.testing.assert_array_equal(gb, wb)
        assert gs == ws == 0.0


def test_backtrack_entries_strided_matches_jax():
    rng = np.random.default_rng(2)
    n = 0
    for t_global in (0, CH, 2 * CH):
        for seed_ti in range(CH):
            for _ in range(3):
                bb = rng.uniform(0, 120, (2 * TS, 4)).astype(np.float32)
                ba = rng.uniform(size=2 * TS) < 0.75
                box = rng.uniform(0, 120, 4).astype(np.float32)
                args = (bb, ba, t_global, CH, S, seed_ti, box)
                want = jstream._backtrack_entries_strided(*args)
                got = tstream._backtrack_entries_strided(*args)
                _entries_equal(got, want)
                assert all(g < t_global + seed_ti for g, _, _ in got)
                n += len(got)
    assert n > 100


def test_reference_fault_backtrack_snaps_with_option_chunk(nets, monkeypatch):
    """JAX ``stream.py:917``, reproduced: the entries are upsampled with the
    anchor snapped against the option's chunk, not the chunk's valid length.
    A partial chunk of 4 frames seeded at its last frame (3): the scan's
    anchor is sample 1 (frame 2, the last real sample), the upsampler's
    sample 2, so frame 1 (between sample 0 and the anchor) is not emitted;
    snapped against the valid length, it would be. The engines pass
    ``opts.chunk`` on every chunk, the partial last one too."""
    rng = np.random.default_rng(3)
    t_global, seed_ti, valid = 2 * CH, 3, 4
    anchor = TS + tstream._snap_sample(seed_ti, valid, S)
    bb = rng.uniform(0, 120, (2 * TS, 4)).astype(np.float32)
    ba = np.arange(2 * TS) < anchor  # alive before the scan's anchor, as backtrack_seeds
    box = rng.uniform(0, 120, 4).astype(np.float32)
    args = (bb, ba, t_global, CH, S, seed_ti, box)
    got = tstream._backtrack_entries_strided(*args)
    _entries_equal(got, jstream._backtrack_entries_strided(*args))
    frames = [g for g, _, _ in got]
    assert t_global + 1 not in frames and t_global in frames
    fixed = tstream._backtrack_entries_strided(bb, ba, t_global, valid, S, seed_ti, box)
    assert t_global + 1 in [g + (CH - valid) for g, _, _ in fixed]

    calls = []
    entries = tstream._backtrack_entries_strided
    monkeypatch.setattr(tstream, "_backtrack_entries_strided",
                        lambda *a: calls.append((a[2], a[3])) or entries(*a))
    sv, rois = _inputs(36, seed=85)
    for engine in ("host", "fused"):
        tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames), rois,
                             _opts(tstream, engine=engine, track_stride=S, conf_thresh=0.8))
    assert 32 in {t for t, _ in calls}  # a seed in the partial last chunk (frames 32-35)
    assert {c for _, c in calls} == {CH}


# ------------------------------------------------------------------ engines


def _seed_spy(monkeypatch):
    """Records (global seed frame) of every seed both engines hand to the
    shared bookkeeping."""
    seeds = []
    add = tstream._TrackBook.add_chunk

    def spy(self, out, chunk_seeds, Tc, t_global):
        seeds.extend(t_global + ti for _, ti, _, _ in chunk_seeds)
        return add(self, out, chunk_seeds, Tc, t_global)

    monkeypatch.setattr(tstream._TrackBook, "add_chunk", spy)
    return seeds


@pytest.mark.parametrize("stride", [1, 2])
def test_host_engine_equals_fused_bit_for_bit(nets, monkeypatch, stride):
    """Mirrors tests/test_stream.py::test_fused_engine_matches_host and
    ::test_stream_stride2_engine_parity, with their fixture preconditions:
    a short final chunk, seeds in several chunks, a track across a chunk
    boundary, backtracked entries and (stride 2) boundary-fill entries."""
    T = 36
    sv, rois = _inputs(T, seed=85)
    seeds = _seed_spy(monkeypatch)
    res = {}
    for engine in ("host", "fused"):
        res[engine] = tstream.stream_video(
            nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames), rois,
            _opts(tstream, engine=engine, track_stride=stride, conf_thresh=0.8))
    host = res["host"]
    assert T % CH != 0
    assert len({t // CH for t in seeds}) >= 3, seeds
    segs = list(host["tracks"].values())
    assert any(min(t for t, _, _ in s) // CH != max(t for t, _, _ in s) // CH for s in segs)
    assert any(s == 0.0 for seg in segs for _, _, s in seg)  # backtracked entries
    seed_frames = set(seeds)
    fills = [t for seg in segs for t, _, s in seg
             if t % CH == CH - 1 and s != 0.0 and t not in seed_frames]
    assert len(fills) >= 5, fills  # at stride 2 each is a boundary fill
    _assert_bit_equal(res["fused"], host)


@pytest.mark.parametrize("stride", [1, 2])
def test_host_engine_equals_fused_without_mgp_and_backtrack(nets, stride):
    sv, rois = _inputs(20, seed=85)
    res = [tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames), rois,
                                _opts(tstream, engine=engine, track_stride=stride, mgp=False,
                                      backtrack=False, conf_thresh=0.8))
           for engine in ("fused", "host")]
    assert res[1]["boxes"].shape[1] == R  # the native slots only
    assert not any(s == 0.0 for seg in res[1]["tracks"].values() for _, _, s in seg)
    _assert_bit_equal(*res)


@pytest.fixture(scope="module")
def stride2_runs(nets):
    T = 20
    sv, rois = _inputs(T, seed=8)
    out = {}
    for engine in ("host", "fused"):
        out["j" + engine] = jstream.stream_video(
            nets["jdet"], nets["jdp"], nets["jtrk"], nets["jtp"], nets["jcfg"],
            _chunks(sv.frames), rois, _opts(jstream, engine=engine, track_stride=S))
        out["t" + engine] = tstream.stream_video(
            nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames), rois,
            _opts(tstream, engine=engine, track_stride=S))
    return rois, out


@pytest.mark.parametrize("engine", ["host", "fused"])
def test_stride2_stream_matches_jax(stride2_runs, engine):
    rois, out = stride2_runs
    want = out["j" + engine]
    _preconditions(want, rois)
    segs = want["tracks"].values()
    assert any(t % CH == CH - 1 and s != 0.0 for seg in segs for t, _, s in seg)
    _compare_results(out["t" + engine], want)


def test_reference_fault_fresh_seed_has_no_forward_entries(stride2_runs):
    """JAX ``stream.py:271``, reproduced: a track seeded at stride 2 has no
    entry after its seed frame inside the seed's chunk (its forward scan
    starts with the next chunk), in the port's engines as in JAX's."""
    _, out = stride2_runs
    n_gaps = 0
    for res in out.values():
        for seg in res["tracks"].values():
            seed_t = next(t for t, _, s in seg if s != 0.0)  # the first non-backtracked entry
            chunk_end = (seed_t // CH + 1) * CH
            assert not [t for t, _, _ in seg if seed_t < t < chunk_end]
            n_gaps += (seed_t < chunk_end - 1) and any(t >= chunk_end for t, _, _ in seg)
    assert n_gaps > 0  # tracks that live on after a gap


def _midpoints(res, T):
    """Checks skipped frames against the midpoints of their neighbours (as
    tests/test_stream.py::test_stream_stride2_interpolation_semantics);
    returns (checked, at a chunk boundary)."""
    checked = boundary = 0
    for seg in res["tracks"].values():
        by_t = {t: (b, s) for t, b, s in seg}
        seed_t = max(seg, key=lambda e: e[2])[0]
        for t in range(1, T - 1, 2):
            if not {t - 1, t, t + 1} <= set(by_t) or seed_t in (t - 1, t, t + 1):
                continue
            if any(by_t[u][1] == 0.0 for u in (t - 1, t, t + 1)):
                continue
            mid = 0.5 * (by_t[t - 1][0] + by_t[t + 1][0])
            np.testing.assert_allclose(by_t[t][0], mid, rtol=0, atol=1e-5)
            checked += 1
            boundary += t % CH == CH - 1
        if (T - 2 in by_t and T - 1 in by_t and seed_t not in (T - 2, T - 1)
                and by_t[T - 2][1] != 0.0 and by_t[T - 1][1] != 0.0):
            np.testing.assert_array_equal(by_t[T - 1][0], by_t[T - 2][0])  # the end hold
    return checked, boundary


def test_stride2_interpolation_semantics(nets):
    T = 32
    sv, rois = _inputs(T, seed=78)
    out = tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames),
                               rois, _opts(tstream, engine="host", track_stride=S,
                                           conf_thresh=0.2))
    checked, boundary = _midpoints(out, T)
    assert checked >= 5 and boundary >= 1, (checked, boundary)


def test_stride2_structural_contract(nets):
    """Segments sorted, unique and in range; the detection and MGP arrays
    do not depend on the stride (bit-identical to the stride-1 run)."""
    T = 24
    sv, rois = _inputs(T, seed=77)
    s1, s2 = (tstream.stream_video(nets["tdet"], nets["ttrk"], nets["tcfg"], _chunks(sv.frames),
                                   rois, _opts(tstream, engine="host", track_stride=s,
                                               conf_thresh=0.2)) for s in (1, 2))
    assert len(s2["tracks"]) >= 1
    for seg in s2["tracks"].values():
        ts = [t for t, _, _ in seg]
        assert ts == sorted(ts) and len(ts) == len(set(ts)) and 0 <= min(ts) and max(ts) < T
    for k in ("boxes", "scores", "keep"):
        np.testing.assert_array_equal(s1[k], s2[k], err_msg=k)


def test_stream_cli_stride2_matches_jax_cli(nets, tmp_path, monkeypatch):
    strides = []
    run = tstream.stream_video
    monkeypatch.setattr(tstream, "stream_video",
                        lambda *a: strides.append(a[-1].track_stride) or run(*a))
    _, (jd, jt, jk), (td, tt, tk) = _run_clis(nets, tmp_path, monkeypatch, 20,
                                              extra=("--track_stride", "2"))
    assert strides == [2]
    _compare_protos(td, jd, tt, jt, tk, jk)
    assert len(jk["tracks"]) > 0
