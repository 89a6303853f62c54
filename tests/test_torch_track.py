"""Port parity: the correlation tracker (network, one NCC update, batched scan).

The rollout is chaotic (a 1e-6 template difference grows into pixels of
drift over tens of frames), so the tracker is pinned per step and compared
whole only over a short horizon in float32:

- tracker features with converted weights: 1e-4 in float32, 0.1 (a few
  bf16 ulps of O(5) activations) in bf16;
- one ``ncc_update`` on identical features, box and template: boxes to
  1e-3 px, peak confidence to 1e-4 (float32 correlation; the search
  pooling rounds to bf16 in both packages);
- ``track_batch`` over T=8 frames with float32 ``TrackerConfig``, stride 1
  and 2 (with and without bucket padding), and with EMA templates and
  detection snapping: alive bits exact, conf to 1e-3, boxes to 0.5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.video import track as jtrack
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet, extract_template
from vdetlib_tpu_torch.video.track import ncc_update, track_batch, tracker_features
from vdetlib_tpu_torch.weights import tracker_state_from_flax

torch.set_num_threads(2)

HW = (96, 128)
T = 8


def _nets(dtype_j, dtype_t):
    jcfg = jtn.TrackerConfig(dtype=dtype_j)
    jmodel, jparams = jtrack.init_tracker(jcfg, image_hw=HW, seed=0)
    tcfg = TrackerConfig(dtype=dtype_t)
    tmodel = TrackerNet(tcfg)
    tmodel.load_state_dict(tracker_state_from_flax(jax.tree.map(np.asarray, jparams)))
    return jcfg, jmodel, jparams, tcfg, tmodel.eval()


@pytest.fixture(scope="module")
def f32():
    sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=4, seed=2))
    jcfg, jmodel, jparams, tcfg, tmodel = _nets(jnp.float32, torch.float32)
    feats = np.array(jtrack.tracker_features(jmodel, jparams, jnp.asarray(sv.frames)))
    return sv, jcfg, jmodel, tcfg, tmodel, feats


@pytest.mark.parametrize("dtypes, tol", [((jnp.float32, torch.float32), 1e-4),
                                         ((jnp.bfloat16, torch.bfloat16), 0.1)], ids=["f32", "bf16"])
def test_tracker_features_match_jax(dtypes, tol):
    sv = make_video(SynthConfig(num_frames=2, height=HW[0], width=HW[1], seed=1))
    jcfg, jmodel, jparams, tcfg, tmodel = _nets(*dtypes)
    want = np.asarray(jtrack.tracker_features(jmodel, jparams, jnp.asarray(sv.frames)),
                      np.float32)
    with torch.no_grad():
        got = tracker_features(tmodel, torch.from_numpy(sv.frames)).float().numpy()
    assert got.shape == want.shape == (2, 24, 32, 96)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("num_scales", [1, 3])
def test_ncc_update_matches_jax(f32, num_scales):
    sv, jcfg, _, tcfg, _, feats = f32
    jcfg = jtn.TrackerConfig(dtype=jnp.float32, num_scales=num_scales)
    tcfg = TrackerConfig(dtype=torch.float32, num_scales=num_scales)
    K = sv.gt_boxes.shape[0]
    for k in range(K):
        box0, box1 = sv.gt_boxes[k, 2], sv.gt_boxes[k, 3]
        tpl_j = jtn.extract_template(jnp.asarray(feats[2]), jnp.asarray(box0), jcfg)
        nb_j, pk_j = jtrack.ncc_update(jnp.asarray(feats[3]), jnp.asarray(box0), tpl_j, jcfg)
        tpl_t = extract_template(torch.from_numpy(feats[2]), torch.from_numpy(box0), tcfg)
        np.testing.assert_allclose(tpl_t.numpy(), np.asarray(tpl_j), atol=1e-5, rtol=0)
        # identical template into both updates
        tpl = torch.from_numpy(np.array(tpl_j))
        nb_t, pk_t = ncc_update(torch.from_numpy(feats[3])[None], torch.from_numpy(box0)[None, None],
                                tpl[None, None], tcfg)
        np.testing.assert_allclose(nb_t[0, 0].numpy(), np.asarray(nb_j), atol=1e-3, rtol=0)
        np.testing.assert_allclose(float(pk_t[0, 0]), float(pk_j), atol=1e-4, rtol=0)
        assert np.abs(np.asarray(nb_j) - box1).max() < 40  # it tracks, not wanders


@pytest.mark.parametrize("stride, pad", [(1, 0), (2, 0), (2, 3)])
def test_track_batch_matches_jax(f32, stride, pad):
    sv, jcfg, jmodel, tcfg, _, feats = f32
    K = sv.gt_boxes.shape[0]
    anchor_t = np.array([0, 3, 7, 5, 6][:K] * (1 + K // 5))[:K]
    if pad:
        anchor_t[0] = T - 1  # the anchor whose stride snap rounds past the real end
    boxes = np.stack([sv.gt_boxes[k, anchor_t[k]] for k in range(K)]).astype(np.float32)
    fe = np.concatenate([feats, np.repeat(feats[-1:], pad, 0)]) if pad else feats
    kw_j, kw_t = {}, {}
    if stride > 1:
        kw_j = dict(frame_stride=stride, feats_strided=True, full_t=T + pad)
        kw_t = dict(kw_j)
        if pad:
            kw_j["valid_t"] = jnp.int32(T)
            kw_t["valid_t"] = torch.tensor(T)
    fs = fe[::stride] if stride > 1 else fe
    jb, jc, ja = jtrack.track_batch(jmodel, jcfg, jnp.asarray(fs), jnp.asarray(anchor_t),
                                    jnp.asarray(boxes), 0.5, **kw_j)
    with torch.no_grad():
        tb, tc, ta = track_batch(tcfg, torch.from_numpy(fs), torch.from_numpy(anchor_t),
                                 torch.from_numpy(boxes), 0.5, **kw_t)
    ja = np.asarray(ja)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3, rtol=0)
    live = ja
    np.testing.assert_allclose(tb.numpy()[live], np.asarray(jb)[live], atol=0.5, rtol=0)
    # anchor frames re-asserted exactly; tracks survive beyond their anchors
    np.testing.assert_array_equal(tb.numpy()[np.arange(K), anchor_t], boxes)
    assert live.sum() > 2 * K


def test_track_batch_ema_and_snap_options_match_jax(f32):
    """EMA templates and detection snapping (once refused by the port) run
    and agree with JAX under the bounds above; tests/test_torch_track_options.py
    holds each option alone, at stride 2 and on hard-tier videos."""
    sv, jcfg, jmodel, _, _, feats = f32
    K = sv.gt_boxes.shape[0]
    anchor_t = np.array([0, 3, 7, 5, 6][:K])
    boxes = np.stack([sv.gt_boxes[k, anchor_t[k]] for k in range(K)]).astype(np.float32)
    rng = np.random.default_rng(4)
    sb = (sv.gt_boxes.transpose(1, 0, 2) + rng.normal(0, 3, (T, K, 4))).astype(np.float32)
    ss = rng.uniform(0.3, 1.0, (T, K)).astype(np.float32)
    sv_ = np.ones((T, K), bool)
    kw = dict(template_eta=0.1, template_update_conf=0.3)
    jcfg = jtn.TrackerConfig(dtype=jnp.float32, **kw)
    tcfg = TrackerConfig(dtype=torch.float32, **kw)
    jb, jc, ja = jtrack.track_batch(jmodel, jcfg, jnp.asarray(feats), jnp.asarray(anchor_t),
                                    jnp.asarray(boxes), 0.5,
                                    snap=tuple(jnp.asarray(a) for a in (sb, ss, sv_)),
                                    snap_iou=0.3, snap_weight=0.5)
    with torch.no_grad():
        tb, tc, ta = track_batch(tcfg, torch.from_numpy(feats), torch.from_numpy(anchor_t),
                                 torch.from_numpy(boxes), 0.5,
                                 snap=tuple(torch.from_numpy(a) for a in (sb, ss, sv_)),
                                 snap_iou=0.3, snap_weight=0.5)
    ja = np.asarray(ja)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tb.numpy()[ja], np.asarray(jb)[ja], atol=0.5, rtol=0)
    assert ja.sum() > 2 * K


@pytest.mark.parametrize("stride", [1, 2])
def test_greedy_track_rounds_tie_order_matches_jax(f32, stride):
    """Greedy anchor rounds with exactly tied scores: picks go by (score desc,
    file-order index asc), so the K track slots come out in the JAX order;
    the fixed ceil(K/A)-round loop equals the JAX while_loop."""
    from vdetlib_tpu.pipeline import fused as jfused
    from vdetlib_tpu_torch.pipeline import fused as tfused

    sv, jcfg, jmodel, tcfg, _, feats = f32
    rng = np.random.default_rng(7)
    K_obj, M = sv.gt_boxes.shape[0], 6
    boxes = np.zeros((T, M, 4), np.float32)
    for t in range(T):
        k = rng.integers(0, K_obj, M)
        boxes[t] = sv.gt_boxes[k, t] + rng.normal(0, 2, (M, 4)).astype(np.float32)
    scores = np.full((T, M), 0.9, np.float32)  # every candidate tied
    scores[:, ::3] = 0.8
    mask = rng.uniform(size=(T, M)) > 0.3
    frame_ok = np.ones(T, bool)
    kw = dict(image_hw=HW, anchors_per_round=3, max_tracks=7, track_stride=stride)
    jc, tc = jfused.FusedConfig(**kw), tfused.FusedConfig(**kw)
    fs = feats[::stride]
    want = jfused._greedy_track_rounds(jmodel, jcfg, jc, jnp.asarray(fs), jnp.asarray(boxes),
                                       jnp.asarray(scores), jnp.asarray(mask),
                                       jnp.asarray(frame_ok))
    with torch.no_grad():
        got = tfused._greedy_track_rounds(tcfg, tc, torch.from_numpy(fs), torch.from_numpy(boxes),
                                          torch.from_numpy(scores), torch.from_numpy(mask),
                                          torch.from_numpy(frame_ok))
    wb, wc, wa, wn = (np.asarray(x) for x in want)
    gb, gc, ga, gn = (x.numpy() for x in got)
    assert int(gn) == int(wn) > 3  # more than one round ran
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gb[wa], wb[wa], atol=0.5, rtol=0)
    np.testing.assert_allclose(gc, wc, atol=1e-3, rtol=0)
