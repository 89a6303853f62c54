"""Port parity: the tracker's options — detection snapping, EMA templates and
several scales — against the JAX package.

The float32 tracker with converted weights (as tests/test_torch_track.py),
its features computed once by the JAX network and fed to both packages.
Bounds:

- ``snap_to_dets``: exactly JAX's result (the same float32 operations in
  the same order), and exactly the same result under any permutation of
  the det slots, on cases built with exact score, IoU and coordinate ties;
- rollouts (``track_batch`` with ``snap=``, EMA templates on hard-tier
  videos, ``num_scales`` 3, ``_track_one_direction``) over T <= 10 steps in
  float32: alive bits exact, conf within 1e-3 and live boxes within 0.5 px
  (the bound of tests/test_torch_track.py: the rollout is chaotic, one
  step is pinned to 1e-3 px there);
- the EMA checks of the JAX package's tests/test_template_eta.py, held here
  for the port: eta 0 equals the default configuration bit for bit; an
  update threshold no peak reaches leaves the frozen rollout bit for bit;
  the stream's ``track_chunk`` returns its input templates at eta 0 and an
  adapted, unit-norm carry at eta > 0, equal to JAX's within 1e-3.

``track_from_det`` and the ``track`` tool with ``--snap_weight``:
tests/test_torch_staged.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, hard_config, make_video
from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.video import stream as jstream
from vdetlib_tpu.video import track as jtrack
from vdetlib_tpu_torch.data.synth import hard_config as t_hard_config
from vdetlib_tpu_torch.data.synth import make_video as t_make_video
from vdetlib_tpu_torch.kernels import track_scan as ks
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet, extract_template
from vdetlib_tpu_torch.video import stream as tstream
from vdetlib_tpu_torch.video import track as ttrack
from vdetlib_tpu_torch.weights import tracker_state_from_flax

torch.set_num_threads(2)

HW = (96, 128)
T = 10
SNAP = dict(snap_iou=0.3, snap_weight=0.5)


@pytest.fixture(scope="module")
def nets():
    jcfg = jtn.TrackerConfig(dtype=jnp.float32)
    jmodel, jparams = jtrack.init_tracker(jcfg, image_hw=HW, seed=0)
    tmodel = TrackerNet(TrackerConfig(dtype=torch.float32))
    tmodel.load_state_dict(tracker_state_from_flax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel.eval()


def _feats(nets, frames):
    jmodel, jparams, _ = nets
    return np.asarray(jtrack.tracker_features(jmodel, jparams, jnp.asarray(frames)))


@pytest.fixture(scope="module")
def easy(nets):
    sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=4, seed=2))
    return sv, _feats(nets, sv.frames)


@pytest.fixture(scope="module")
def hard(nets):
    """A hard-tier clip with strong appearance drift (the regime the EMA is
    for), the port's frames byte for byte the JAX generator's."""
    kw = dict(num_frames=T, seed=11, height=HW[0], width=HW[1], num_occluders=0,
              num_distractors=1, camera_pan_amp=4.0, appearance_drift=0.6)
    sv = make_video(hard_config(**kw))
    assert t_make_video(t_hard_config(**kw)).frames.tobytes() == sv.frames.tobytes()
    return sv, _feats(nets, sv.frames)


def _snap_arrays(sv, seed, n=8):
    """Per-frame det sets: jittered ground truth, clutter, invalid slots."""
    rng = np.random.default_rng(seed)
    K = sv.gt_boxes.shape[0]
    Tn = sv.gt_boxes.shape[1]
    boxes = np.zeros((Tn, n, 4), np.float32)
    boxes[:, :K] = sv.gt_boxes.transpose(1, 0, 2) + rng.normal(0, 3, (Tn, K, 4))
    boxes[:, K:] = rng.uniform(0, 60, (Tn, n - K, 1)) + np.array([0, 0, 30, 30])
    scores = rng.uniform(0.2, 1.0, (Tn, n)).astype(np.float32)
    valid = rng.uniform(size=(Tn, n)) > 0.2
    return boxes, scores, valid


def _anchors(sv, ts, seed=0):
    K = sv.gt_boxes.shape[0]
    ts = np.asarray(ts)
    k = np.arange(len(ts)) % K
    jit = np.random.default_rng(seed).normal(0, 1.5, (len(ts), 4))
    return ts, (sv.gt_boxes[k, ts] + jit).astype(np.float32)


def _check_rollout(got, want, min_live=4):
    (gb, gc, ga), (wb, wc, wa) = ([np.asarray(x) for x in o] for o in (got, want))
    np.testing.assert_array_equal(ga, wa)
    assert wa.sum() >= min_live
    np.testing.assert_allclose(gc, wc, atol=1e-3, rtol=0)
    np.testing.assert_allclose(gb[wa], wb[wa], atol=0.5, rtol=0)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ snap_to_dets


def _tie_cases():
    """(box, det_boxes, det_scores, det_valid) cases, each lane built so that
    a tie-break decides: exact score ties, exact IoU ties (mirror-image
    dets), coordinate ties, duplicates, invalid best dets, no candidate."""
    box = np.array([20.0, 20.0, 60.0, 60.0], np.float32)
    a = np.array([22.0, 18.0, 62.0, 58.0], np.float32)  # IoU with box ...
    b = np.array([18.0, 22.0, 58.0, 62.0], np.float32)  # ... equal to a's
    c = np.array([21.0, 21.0, 61.0, 61.0], np.float32)
    far = np.array([100.0, 100.0, 120.0, 120.0], np.float32)
    cases = [
        ([a, b, c, far], [0.9, 0.9, 0.8, 0.99], [1, 1, 1, 1]),  # score tie, IoU tie
        ([b, a, c, far], [0.9, 0.9, 0.8, 0.99], [1, 1, 1, 1]),  # ... other slot order
        ([c, a, b, far], [0.9, 0.9, 0.9, 0.99], [1, 1, 1, 1]),  # IoU decides
        ([a, a, b, c], [0.7, 0.7, 0.7, 0.95], [1, 1, 1, 0]),  # the best is invalid
        ([far, far, far, far], [0.9, 0.8, 0.7, 0.6], [1, 1, 1, 1]),  # no candidate
        ([a, b, a, b], [0.5, 0.5, 0.5, 0.5], [0, 1, 0, 1]),
    ]
    bx = np.stack([box] * len(cases))
    db = np.stack([np.stack(c[0]) for c in cases]).astype(np.float32)
    ds = np.asarray([c[1] for c in cases], np.float32)
    dv = np.asarray([c[2] for c in cases], bool)
    rng = np.random.default_rng(3)  # random lanes: boxes near a random det set
    n, L = 4, 40
    rdb = rng.uniform(0, 80, (L, n, 2))
    rdb = np.concatenate([rdb, rdb + rng.uniform(10, 40, (L, n, 2))], -1).astype(np.float32)
    rdb[:, 3] = rdb[:, 1]  # duplicates
    rbx = (rdb[:, 0] + rng.normal(0, 3, (L, 4))).astype(np.float32)
    rds = rng.choice([0.3, 0.6, 0.9], (L, n)).astype(np.float32)  # frequent score ties
    rdv = rng.uniform(size=(L, n)) > 0.25
    return (np.concatenate([bx, rbx]), np.concatenate([db, rdb]), np.concatenate([ds, rds]),
            np.concatenate([dv, rdv]))


@pytest.mark.parametrize("snap_iou, snap_weight", [(0.5, 0.5), (0.3, 0.3)])
def test_snap_to_dets_matches_jax_and_ignores_slot_order(snap_iou, snap_weight):
    box, db, ds, dv = _tie_cases()
    want_b, want_c = (np.asarray(x) for x in jax.vmap(
        lambda b, d, s, v: jtrack.snap_to_dets(b, d, s, v, snap_iou, snap_weight))(
        *(jnp.asarray(x) for x in (box, db, ds, dv))))
    got_b, got_c = ks.snap_to_dets(_t(box), _t(db), _t(ds), _t(dv), snap_iou, snap_weight)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    assert want_c.sum() > len(want_c) // 2 and not want_c.all()
    assert (want_b[4] == box[4]).all()  # no candidate: the box stays
    np.testing.assert_array_equal(got_b.numpy()[0], got_b.numpy()[1])  # slot order
    rng = np.random.default_rng(0)
    for _ in range(5):
        perm = rng.permutation(db.shape[1])
        pb, pc = ks.snap_to_dets(_t(box), _t(db[:, perm]), _t(ds[:, perm]), _t(dv[:, perm]),
                                 snap_iou, snap_weight)
        np.testing.assert_array_equal(pb.numpy(), got_b.numpy())
        np.testing.assert_array_equal(pc.numpy(), got_c.numpy())


# ------------------------------------------------------------------ track_batch


def _both_track_batch(nets, jcfg, tcfg, feats, ats, boxes, snap=None, stride=1, pad=0,
                      conf=0.3):
    jmodel = nets[0]
    Tf = feats.shape[0]
    fe = np.concatenate([feats, np.repeat(feats[-1:], pad, 0)]) if pad else feats
    kw_j, kw_t = {}, {}
    if snap is not None:
        if pad:
            snap = tuple(np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                         for a in snap)
        kw_j = dict(snap=tuple(jnp.asarray(a) for a in snap), **SNAP)
        kw_t = dict(snap=tuple(_t(a) for a in snap), **SNAP)
    if stride > 1:
        for kw in (kw_j, kw_t):
            kw.update(frame_stride=stride, feats_strided=True, full_t=Tf + pad)
        if pad:
            kw_j["valid_t"] = jnp.int32(Tf)
            kw_t["valid_t"] = torch.tensor(Tf)
        fe = fe[::stride]
    want = jtrack.track_batch(jmodel, jcfg, jnp.asarray(fe), jnp.asarray(ats),
                              jnp.asarray(boxes), conf, **kw_j)
    with torch.no_grad():
        got = ttrack.track_batch(tcfg, _t(fe), _t(ats), _t(boxes), conf, **kw_t)
    return got, want


@pytest.mark.parametrize("stride, pad", [(1, 0), (2, 0), (2, 3)])
def test_track_batch_snap_matches_jax(nets, easy, stride, pad):
    sv, feats = easy
    ats, boxes = _anchors(sv, [0, 3, 9, 5, 6])
    snap = _snap_arrays(sv, seed=stride + pad)
    got, want = _both_track_batch(nets, jtn.TrackerConfig(dtype=jnp.float32),
                                  TrackerConfig(dtype=torch.float32), feats, ats, boxes,
                                  snap=snap, stride=stride, pad=pad)
    _check_rollout(got, want)
    # the snapping engages: the rollout differs from the unsnapped one
    plain, _ = _both_track_batch(nets, jtn.TrackerConfig(dtype=jnp.float32),
                                 TrackerConfig(dtype=torch.float32), feats, ats, boxes,
                                 stride=stride, pad=pad)
    assert np.abs(got[0].numpy() - plain[0].numpy()).max() > 0.5
    np.testing.assert_array_equal(got[0].numpy()[np.arange(len(ats)), ats], boxes)


@pytest.mark.parametrize("stride", [1, 2])
def test_track_batch_ema_matches_jax(nets, hard, stride):
    sv, feats = hard
    ats, boxes = _anchors(sv, [0, 4, 9, 2])
    got, want = _both_track_batch(
        nets, jtn.TrackerConfig(dtype=jnp.float32, template_eta=0.1, template_update_conf=0.3),
        TrackerConfig(dtype=torch.float32, template_eta=0.1, template_update_conf=0.3),
        feats, ats, boxes, stride=stride)
    _check_rollout(got, want)
    frozen, _ = _both_track_batch(nets, jtn.TrackerConfig(dtype=jnp.float32),
                                  TrackerConfig(dtype=torch.float32), feats, ats, boxes,
                                  stride=stride)
    assert np.abs(got[0].numpy() - frozen[0].numpy()).max() > 1e-3  # the EMA engages


def test_track_batch_snap_and_ema_together_match_jax(nets, hard):
    sv, feats = hard
    ats, boxes = _anchors(sv, [1, 8, 5])
    kw = dict(template_eta=0.2, template_update_conf=0.3)
    got, want = _both_track_batch(nets, jtn.TrackerConfig(dtype=jnp.float32, **kw),
                                  TrackerConfig(dtype=torch.float32, **kw), feats, ats, boxes,
                                  snap=_snap_arrays(sv, seed=5))
    _check_rollout(got, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_track_batch_three_scales_matches_jax(nets, easy, stride):
    sv, feats = easy
    ats, boxes = _anchors(sv, [0, 5, 9])
    got, want = _both_track_batch(nets, jtn.TrackerConfig(dtype=jnp.float32, num_scales=3),
                                  TrackerConfig(dtype=torch.float32, num_scales=3), feats, ats,
                                  boxes, stride=stride)
    _check_rollout(got, want)


def test_kernel_gate_excludes_every_option():
    """Kernel F takes one scale and frozen templates; snapping is decided by
    ``track_batch`` (``snap is None``). Unlike the JAX package's Pallas gate,
    EMA templates are excluded."""
    assert ks.kernel_takes(TrackerConfig())
    assert not ks.kernel_takes(TrackerConfig(template_eta=0.1))
    assert not ks.kernel_takes(TrackerConfig(num_scales=3))


def test_track_batch_options_take_the_plain_scan(easy, monkeypatch):
    """The scan is chosen from the configuration: kernel F's wrapper only
    where ``kernel_takes(cfg) and snap is None``."""
    sv, feats = easy
    ats, boxes = _anchors(sv, [0, 5])
    calls = []
    real = ks.track_scan_kernel
    monkeypatch.setattr(ttrack, "track_scan_kernel",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    f, a, b = _t(feats), _t(ats), _t(boxes)
    snap = tuple(_t(x) for x in _snap_arrays(sv, 0))
    with torch.no_grad():
        ttrack.track_batch(TrackerConfig(dtype=torch.float32), f, a, b, 0.3)
        assert len(calls) == 1
        ttrack.track_batch(TrackerConfig(dtype=torch.float32), f, a, b, 0.3, snap=snap)
        ttrack.track_batch(TrackerConfig(dtype=torch.float32, template_eta=0.1), f, a, b, 0.3)
        ttrack.track_batch(TrackerConfig(dtype=torch.float32, num_scales=3), f, a, b, 0.3)
    assert len(calls) == 1


# ------------------------------------------------------------------ one direction


@pytest.mark.parametrize("reverse", [False, True])
def test_track_one_direction_matches_jax_and_the_folded_scan(nets, hard, reverse):
    """JAX's one-anchor scan vmapped against the port's L-lane scan, with
    snapping and EMA; and the port's two one-direction scans against its
    folded ``track_batch`` on the frames each direction owns."""
    sv, feats = hard
    ats, boxes = _anchors(sv, [0, 4, 9])
    snap = _snap_arrays(sv, seed=7)
    kw = dict(template_eta=0.1, template_update_conf=0.3)
    jcfg = jtn.TrackerConfig(dtype=jnp.float32, **kw)
    tcfg = TrackerConfig(dtype=torch.float32, **kw)
    jf = jnp.asarray(feats)
    tpl = np.asarray(jax.vmap(lambda t, b: jtn.extract_template(jf[t], b, jcfg))(
        jnp.asarray(ats), jnp.asarray(boxes)))
    want = jax.vmap(lambda t, b, tp: jtrack._track_one_direction(
        jf, t, b, tp, jcfg, 0.3, reverse, snap=tuple(jnp.asarray(a) for a in snap), **SNAP))(
        jnp.asarray(ats), jnp.asarray(boxes), jnp.asarray(tpl))
    with torch.no_grad():
        got = ttrack._track_one_direction(_t(feats), _t(ats), _t(boxes), _t(tpl), tcfg, 0.3,
                                          reverse, snap=tuple(_t(a) for a in snap), **SNAP)
        folded = ttrack.track_batch(tcfg, _t(feats), _t(ats), _t(boxes), 0.3,
                                    snap=tuple(_t(a) for a in snap), **SNAP)
    # JAX's one-direction scan leaves the frames before the anchor dead
    _check_rollout(got, want)
    own = np.arange(T)[None, :] >= ats[:, None]
    if reverse:
        own = np.arange(T)[None, :] <= ats[:, None]
    gb, gc, ga = (x.numpy() for x in got)
    fb, fc, fa = (x.numpy() for x in folded)
    # the same lanes batched otherwise: alive exact, the JAX package's bound
    # for its folded scan against two scans (tests/test_track.py)
    np.testing.assert_array_equal(fa[own], ga[own])
    np.testing.assert_allclose(fc[own], gc[own], atol=1e-3, rtol=0)
    np.testing.assert_allclose(fb[own & ga], gb[own & ga], atol=0.05, rtol=0)


# ------------------------------------------------------------------ EMA contract


def _port_run(feats, sv, cfg):
    K = sv.gt_boxes.shape[0]
    with torch.no_grad():
        return [x.numpy() for x in ttrack.track_batch(
            cfg, _t(feats), torch.zeros(K, dtype=torch.int64), _t(sv.gt_boxes[:, 0]), 0.3)]


def test_eta_zero_equals_the_default_configuration(hard):
    sv, feats = hard
    want = _port_run(feats, sv, TrackerConfig(dtype=torch.float32))
    got = _port_run(feats, sv, TrackerConfig(dtype=torch.float32, template_eta=0.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_eta_confidence_gate_blocks_updates(hard):
    sv, feats = hard
    b0, c0, a0 = _port_run(feats, sv, TrackerConfig(dtype=torch.float32))
    bg, cg, ag = _port_run(feats, sv, TrackerConfig(dtype=torch.float32, template_eta=0.1,
                                                    template_update_conf=2.0))
    np.testing.assert_array_equal(ag, a0)
    np.testing.assert_array_equal(bg, b0)
    np.testing.assert_array_equal(cg, c0)
    be, _, ae = _port_run(feats, sv, TrackerConfig(dtype=torch.float32, template_eta=0.1,
                                                   template_update_conf=0.3))
    K = sv.gt_boxes.shape[0]
    np.testing.assert_array_equal(be[np.arange(K), 0], sv.gt_boxes[:, 0])  # anchor contract
    assert ae[:, 0].all() and np.abs(be - b0).max() > 1e-3


@pytest.mark.parametrize("strided", [False, True])
def test_track_chunk_template_carry_matches_jax(nets, hard, strided):
    """The stream's slot advance: the input templates come back at eta 0; at
    eta > 0 the carry adapts, stays unit-norm and equals JAX's."""
    sv, feats = hard
    fs = feats[::2] if strided else feats
    jcfg0, tcfg0 = jtn.TrackerConfig(dtype=jnp.float32), TrackerConfig(dtype=torch.float32)
    boxes0 = sv.gt_boxes[:, 0].astype(np.float32)
    A = boxes0.shape[0]
    tpl = np.asarray(jax.vmap(lambda b: jtn.extract_template(jnp.asarray(feats[0]), b, jcfg0))(
        jnp.asarray(boxes0)))
    np.testing.assert_allclose(extract_template(_t(feats[0])[None].expand(A, -1, -1, -1),
                                                _t(boxes0), tcfg0).numpy(), tpl, atol=1e-5)
    alive0 = np.ones(A, bool)
    kw = dict(template_eta=0.2, template_update_conf=0.3)
    jcfg, tcfg = jtn.TrackerConfig(dtype=jnp.float32, **kw), TrackerConfig(dtype=torch.float32,
                                                                           **kw)
    args = (tpl, boxes0, alive0)
    with torch.no_grad():
        if strided:
            bnd = (boxes0, np.ones(A, np.float32), alive0)
            want = jstream.track_chunk_strided(jcfg, jnp.asarray(fs), *(jnp.asarray(a) for a in
                                               args + bnd), 0.2, 2, 2 * fs.shape[0])
            got = tstream.track_chunk_strided(tcfg, _t(fs), *(_t(a) for a in args + bnd), 0.2,
                                              2, 2 * fs.shape[0])
            frozen = tstream.track_chunk_strided(tcfg0, _t(fs), *(_t(a) for a in args + bnd),
                                                 0.2, 2, 2 * fs.shape[0])
            tpl_end_w, tpl_end_g, tpl0 = want[6], got[6], frozen[6]
        else:
            want = jstream.track_chunk(jcfg, jnp.asarray(fs), *(jnp.asarray(a) for a in args),
                                       0.2)
            got = tstream.track_chunk(tcfg, _t(fs), *(_t(a) for a in args), 0.2)
            tpl0 = tstream.track_chunk(tcfg0, _t(fs), *(_t(a) for a in args), 0.2)[5]
            tpl_end_w, tpl_end_g = want[5], got[5]
    np.testing.assert_array_equal(tpl0.numpy(), tpl)
    _check_rollout(got[:3], want[:3])
    g, w = tpl_end_g.numpy(), np.asarray(tpl_end_w)
    changed = np.abs(w - tpl).reshape(A, -1).max(1) > 1e-4
    assert changed.any()
    np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.sqrt((g[changed] ** 2).sum((1, 2, 3))), 1.0, atol=1e-3)
