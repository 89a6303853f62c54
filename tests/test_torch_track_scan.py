"""Port parity: the folded tracker scan (kernel F's plain version).

Same features (the JAX tracker's bf16 output at 96×128, converted weights),
anchors and templates go through:

- ``track_scan_plain`` against the JAX Pallas kernel ``track_scan_pallas`` in
  interpret mode over T=4 frames: all six outputs, indexed by frame;
- the port's ``track_batch`` (which takes the scan of ``kernels/track_scan``)
  against the JAX XLA ``track_batch`` over T=12 frames.

Bounds of tests/test_track.py (the Pallas kernel against the XLA scan): alive
bits equal, live boxes < 0.1 px and live conf < 5e-3 apart. The search
window is pooled in bf16 in every form, and the correlation sums round in
different orders, so the rollout drifts by less than that, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu.kernels.track_pallas import track_scan_pallas
from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.video import track as jtrack
from vdetlib_tpu_torch.kernels import track_scan as ks
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
from vdetlib_tpu_torch.video import track as ttrack

torch.set_num_threads(2)

HW = (96, 128)
T = 12


@pytest.fixture(scope="module")
def bf16():
    """The default (bf16) tracker's features of a 12-frame clip, in both packages."""
    sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=4, seed=3))
    jcfg = jtn.TrackerConfig()
    jmodel, jparams = jtrack.init_tracker(jcfg, image_hw=HW, seed=0)
    jfeats = jtrack.tracker_features(jmodel, jparams, jnp.asarray(sv.frames))
    tfeats = torch.from_numpy(np.asarray(jfeats, np.float32)).to(torch.bfloat16)  # exact
    return sv, jcfg, jmodel, jfeats, tfeats


def _anchors(sv, ts):
    K = sv.gt_boxes.shape[0]
    k = np.arange(len(ts)) % K
    jit = np.random.default_rng(len(ts)).normal(0, 2, (len(ts), 4))
    return np.asarray(ts), (sv.gt_boxes[k, np.asarray(ts)] + jit).astype(np.float32)


def _check(got_a, want_a, got_b, want_b, got_c, want_c):
    np.testing.assert_array_equal(got_a, want_a)
    live = want_a
    assert live.any()
    db = np.abs(got_b - want_b)[live].max()
    dc = np.abs(got_c - want_c)[live].max()
    assert db < 0.1 and dc < 5e-3, (db, dc)


def test_scan_plain_matches_jax_pallas_interpret(bf16):
    sv, jcfg, _, jfeats, tfeats = bf16
    Tc = 4
    ats, boxes = _anchors(sv, [0, 1, 2, 3, 3, 0])
    tpl = jax.vmap(lambda at, ab: jtn.extract_template(jfeats[at], ab, jcfg))(
        jnp.asarray(ats), jnp.asarray(boxes))
    want = track_scan_pallas(jfeats[:Tc], jnp.asarray(ats), jnp.asarray(boxes), tpl,
                             Q=jcfg.search_pool, P=jcfg.template_pool, factor=jcfg.search_factor,
                             stride=jcfg.stride, conf_thresh=0.3, interpret=True)
    with torch.no_grad():
        got = ks.track_scan_plain(tfeats[:Tc], torch.from_numpy(ats), torch.from_numpy(boxes),
                                  torch.from_numpy(np.array(tpl)), TrackerConfig(), 0.3)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for gb, gc, ga, wb, wc, wa in ((*got[:3], *want[:3]), (*got[3:], *want[3:])):
        assert gb.shape == wb.shape == (Tc, len(ats), 4)
        _check(ga, wa, gb, wb, gc, wc)


def test_track_batch_matches_jax_xla_scan(bf16):
    sv, jcfg, jmodel, jfeats, tfeats = bf16
    ats, boxes = _anchors(sv, [2, T // 2, T - 2, 0, T - 1, 5])
    want = jtrack.track_batch(jmodel, jcfg, jfeats, jnp.asarray(ats), jnp.asarray(boxes), 0.3)
    with torch.no_grad():
        got = ttrack.track_batch(TrackerConfig(), tfeats, torch.from_numpy(ats),
                                 torch.from_numpy(boxes), 0.3)
    (wb, wc, wa), (gb, gc, ga) = ([np.asarray(x) for x in want], [x.numpy() for x in got])
    _check(ga, wa, gb, wb, gc, wc)
    assert wa.sum() > 2 * len(ats)  # tracks survive beyond their anchors


def test_cpu_wrapper_takes_the_plain_loop(bf16):
    sv, jcfg, _, jfeats, tfeats = bf16
    ats, boxes = _anchors(sv, [1, 4])
    tpl = torch.from_numpy(np.array(jax.vmap(
        lambda at, ab: jtn.extract_template(jfeats[at], ab, jcfg))(jnp.asarray(ats),
                                                                   jnp.asarray(boxes))))
    args = (tfeats[:6], torch.from_numpy(ats), torch.from_numpy(boxes), tpl, TrackerConfig(), 0.3)
    before = ks.track_scan_kernel.launches
    with torch.no_grad():
        got, want = ks.track_scan_kernel(*args), ks.track_scan_plain(*args)
    assert ks.track_scan_kernel.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cfg, takes", [
    (TrackerConfig(), True),
    (TrackerConfig(dtype=torch.float32), True),
    (TrackerConfig(num_scales=3), False),
    (TrackerConfig(template_pool=6), True),
    (TrackerConfig(search_factor=2.5), True),
    (TrackerConfig(template_eta=0.1), False),
], ids=["default", "f32", "scales3", "pool6", "factor2.5", "eta"])
def test_kernel_contract(cfg, takes):
    """The JAX gate: one scale and frozen templates, whatever the pools."""
    assert ks.kernel_takes(cfg) is takes


@pytest.mark.parametrize("kw, routed", [({}, True), ({"search_factor": 1.5}, True),
                                        ({"num_scales": 3}, False)],
                         ids=["default", "factor1.5", "scales3"])
def test_track_batch_routes_by_configuration(bf16, monkeypatch, kw, routed):
    """Inside the kernel's contract (any pools) track_batch calls
    track_scan_kernel (the plain loop on a CPU tensor); with num_scales > 1
    it runs the plain loop."""
    sv, _, _, _, tfeats = bf16
    calls = []

    def spy(*a):
        calls.append(1)
        return ks.track_scan_plain(*a)

    monkeypatch.setattr(ttrack, "track_scan_kernel", spy)
    ats, boxes = _anchors(sv, [3])
    with torch.no_grad():
        b, c, a = ttrack.track_batch(TrackerConfig(**kw), tfeats[:6],
                                     torch.from_numpy(ats), torch.from_numpy(boxes), 0.3)
    assert len(calls) == int(routed)
    assert b.shape == (1, 6, 4) and bool(a[0, 3]) and float(c[0, 3]) == 1.0


def test_ncc_update_is_the_scan_step():
    """video.track re-exports the plain step the kernel replaces."""
    assert ttrack.ncc_update is ks.ncc_update


@pytest.mark.parametrize("bf16, elem", [(True, 2), (False, 4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("parts", [8, 1], ids=["P_partials", "one_partial"])
def test_smem_bytes_follow_the_kernel_layout(bf16, elem, parts):
    """csrc/track_scan.cu lays out one block's shared memory as the pooled
    window in the features' type (16-byte aligned), then in float32 the
    template, the partial responses, the row sums of the bins' norms and the
    bins' norms."""
    Q, P, C, R = 16, 8, 96, 9
    want = Q * Q * C * elem + 4 * (P * P * C + parts * R * R + Q * R + Q * Q)
    assert ks._smem_bytes(Q, P, C, bf16, parts) == want
    assert ks._smem_bytes(13, 8, 3, bf16, parts) % 4 == 0
    # the window's end is rounded up to 16 bytes: 13 x 13 x 3 bf16 = 1014 -> 1024
    assert ks._smem_bytes(13, 8, 3, True, parts) - 4 * (64 * 3 + parts * 36 + 13 * 6 + 169) == 1024


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("Q, P", [(12, 8), (16, 8), (20, 8), (12, 6)])
def test_launch_plan_admits_the_trackers_pools(Q, P, bf16):
    """The search windows of the card tests and of chip_smoke.py (factors 1.5,
    2 and 2.5 at P = 8; P = 6) keep a partial response per template row."""
    assert ks.launch_parts(Q, P, 96, bf16) == P
    assert ks._smem_bytes(Q, P, 96, bf16, P) <= ks.SMEM_LIMIT


@pytest.mark.parametrize("bf16, last_p, last_1", [(True, 30, 32), (False, 22, 23)],
                         ids=["bf16", "f32"])
def test_launch_plan_refuses_the_first_shape_that_does_not_fit(bf16, last_p, last_1):
    """At P = 8, C = 96: P partials up to Q = last_p, one partial up to last_1,
    and Q = last_1 + 1 does not fit a block's shared memory."""
    assert ks.launch_parts(last_p, 8, 96, bf16) == 8
    assert ks.launch_parts(last_p + 1, 8, 96, bf16) == 1
    assert ks.launch_parts(last_1, 8, 96, bf16) == 1
    with pytest.raises(ValueError, match="shared memory"):
        ks.launch_parts(last_1 + 1, 8, 96, bf16)


@pytest.mark.parametrize("A, n_cta", [(1, 4), (8, 4), (16, 4), (17, 2), (33, 2), (34, 1),
                                      (100, 1)])
def test_cluster_of_a_lane_fits_the_card(A, n_cta):
    """Each of the 2A lanes runs on a cluster of 4 blocks, halved until all
    lanes' clusters fit the H100's 132 SMs at once."""
    assert ks.cluster_ctas(A, 132) == n_cta
    assert n_cta == 1 or 2 * A * n_cta <= 132


@pytest.mark.parametrize("A, n_cta", [(8, 4), (14, 4), (15, 2), (28, 2), (29, 1)])
def test_cluster_of_a_lane_follows_the_cards_sm_count(A, n_cta):
    """The wrapper passes the device's SM count: on a card with 114 SMs
    (H100 PCIe) the clusters halve at smaller A."""
    assert ks.cluster_ctas(A, 114) == n_cta
    assert n_cta == 1 or 2 * A * n_cta <= 114
