"""Port parity: tracker training (vdetlib_tpu_torch/nn/tracker_train.py and
the train_tracker tool) against vdetlib_tpu/nn/tracker_train.py, on the CPU.

``TrackerConfig()`` at 96×128. Tolerances:

- batches of both samplers: identical arrays for one numpy seed;
- ``response_and_target`` at float32: responses within 1e-5, targets
  within 1e-6, in_range equal;
- one step of each recipe at float32: the loss within 1e-5 relative (the
  aware loss's terms too), every gradient within 1e-3 of its tensor's
  largest magnitude (the step itself: see tests/test_torch_train.py). Not
  1e-4 as for the detector: at the seeded init every GroupNorm has unit
  scale and zero bias, so a ReLU's input is the normalised value itself,
  dense around 0, and a position within float error of 0 takes the ReLU's
  other side in one package. Each such flip moves the gradient of the
  layer's GroupNorm bias (and of the layers below it) by that position's
  whole upstream gradient: on the pair batch below, 4.9e-4 of the largest
  element of ``gns.1.bias``, while every layer above stays within 4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig as JSynthConfig
from vdetlib_tpu.data.synth import hard_config as jhard_config
from vdetlib_tpu.data.synth import make_video as jmake_video
from vdetlib_tpu.nn import tracker_train as jtt
from vdetlib_tpu.nn.tracker_net import TrackerConfig as JTrackerConfig
from vdetlib_tpu.video.track import init_tracker as jinit_tracker
from vdetlib_tpu.video.track import tracker_features as jtracker_features
from vdetlib_tpu_torch import weights
from vdetlib_tpu_torch.data.synth import SynthConfig, hard_config, make_video
from vdetlib_tpu_torch.nn import tracker_train as ttt
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet
from vdetlib_tpu_torch.pipeline.checkpoint import load_params
from vdetlib_tpu_torch.video.track import tracker_features
from tests.torch_train_common import assert_grads_close

torch.set_num_threads(2)

HW = (96, 128)


def _videos(hard, n=2, T=24, seed=200):
    mk = (jhard_config, hard_config) if hard else (JSynthConfig, SynthConfig)
    kw = [dict(num_frames=T, height=HW[0], width=HW[1], seed=seed + i) for i in range(n)]
    return [jmake_video(mk[0](**k)) for k in kw], [make_video(mk[1](**k)) for k in kw]


@pytest.fixture(scope="module")
def hard_videos():
    return _videos(hard=True)


@pytest.fixture(scope="module")
def f32_pair():
    jcfg = JTrackerConfig(dtype=jnp.float32)
    jmodel, jparams = jinit_tracker(jcfg, image_hw=HW, seed=0)
    jparams = jax.tree.map(np.asarray, jparams)
    tcfg = TrackerConfig(dtype=torch.float32)
    tmodel = TrackerNet(tcfg)
    tmodel.load_state_dict(weights.tracker_state_from_flax(jparams))
    return jmodel, jcfg, jparams, tmodel, tcfg


def _same_batch(jb, tb):
    assert set(jb) == set(tb)
    for k in jb:
        assert tb[k].dtype == torch.from_numpy(np.array(jb[k])).dtype, k
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def test_pair_batch_matches_jax():
    jv, tv = _videos(hard=False, T=10)
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        _same_batch(jtt.make_tracker_batch(jv, jr, 6), ttt.make_tracker_batch(tv, tr, 6))


def test_aware_batch_matches_jax(hard_videos):
    jv, tv = hard_videos
    jr, tr = np.random.default_rng(1), np.random.default_rng(1)
    jcfg, tcfg = JTrackerConfig(), TrackerConfig()
    for _ in range(2):
        _same_batch(jtt.make_tracker_batch_aware(jv, jr, 16, jcfg),
                    ttt.make_tracker_batch_aware(tv, tr, 16, tcfg))


def test_response_and_target_matches_jax(f32_pair, hard_videos):
    """Each pair of a batch against the JAX function (one pair), and the
    JAX package's test_target_peaks_at_gt_displacement."""
    jmodel, jcfg, jparams, tmodel, tcfg = f32_pair
    jv, tv = hard_videos
    batch = ttt.make_tracker_batch(tv, np.random.default_rng(2), 6)
    jfa = jtracker_features(jmodel, jax.tree.map(jnp.asarray, jparams),
                            jnp.asarray(batch["frames_a"].numpy()))
    jfb = jtracker_features(jmodel, jax.tree.map(jnp.asarray, jparams),
                            jnp.asarray(batch["frames_b"].numpy()))
    with torch.no_grad():
        fa = tracker_features(tmodel, batch["frames_a"])
        fb = tracker_features(tmodel, batch["frames_b"])
        resp, target, in_range = ttt.response_and_target(fa, fb, batch["boxes_a"],
                                                         batch["boxes_b"], tcfg)
    R = tcfg.search_pool - tcfg.template_pool + 1
    assert resp.shape == (6, R, R) and target.shape == (6, R, R)
    for i in range(6):
        jr, jt, ji = jtt.response_and_target(jfa[i], jfb[i], jnp.asarray(batch["boxes_a"][i]),
                                             jnp.asarray(batch["boxes_b"][i]), jcfg)
        np.testing.assert_allclose(resp[i].numpy(), np.asarray(jr), atol=1e-5, rtol=0)
        np.testing.assert_allclose(target[i].numpy(), np.asarray(jt), atol=1e-6, rtol=0)
        assert bool(in_range[i]) == bool(ji)
    np.testing.assert_allclose(target.sum((-2, -1)).numpy()[in_range.numpy()], 1.0, rtol=1e-5)
    # an identity pair puts the target at the centre bin
    _, t0, _ = ttt.response_and_target(fa[:1], fa[:1], batch["boxes_a"][:1],
                                       batch["boxes_a"][:1], tcfg)
    assert np.unravel_index(int(t0[0].argmax()), (R, R)) == ((R - 1) // 2, (R - 1) // 2)


def _jax_loss(jmodel, jcfg, recipe, params, batch):
    loss_fn = jtt.tracker_loss_aware if recipe == "aware" else jtt.tracker_loss
    return loss_fn(jmodel, jcfg, params, batch)


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss, argnums=3, has_aux=True),
                              static_argnums=(0, 1, 2))


def _jax_loss_and_grads(jmodel, jcfg, jparams, batch, recipe):
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (loss, aux), grads = _jax_value_and_grad(jmodel, jcfg, recipe,
                                             jax.tree.map(jnp.asarray, jparams), jb)
    return float(loss), aux, weights.tracker_state_from_flax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("recipe", ["pair", "aware"])
def test_one_step_loss_and_grads_match_jax(f32_pair, hard_videos, recipe):
    jmodel, jcfg, jparams, tmodel, tcfg = f32_pair
    _, tv = hard_videos
    rng = np.random.default_rng(3)
    if recipe == "aware":
        batch = ttt.make_tracker_batch_aware(tv, rng, 8, tcfg)
        assert batch["suppress"].any() and batch["neg_valid"].any()
    else:
        batch = ttt.make_tracker_batch(tv, rng, 8)
    jl, jaux, jg = _jax_loss_and_grads(jmodel, jcfg, jparams, batch, recipe)
    tmodel.zero_grad(set_to_none=True)
    loss, aux = ttt.tracker_loss_for(recipe)(tmodel, tcfg, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    if recipe == "aware":
        assert float(aux["hinge"].detach()) > 0 and float(aux["sup"].detach()) > 0, aux
    assert_grads_close({n: p.grad for n, p in tmodel.named_parameters()}, jg, rel=1e-3)


def test_unknown_recipe_refused():
    with pytest.raises(ValueError):
        ttt.tracker_loss_for("pairs")


def test_training_reduces_loss():
    """The JAX package's tracker test_training_reduces_loss (pair recipe,
    AdamW at 1e-3 with optax's decay, no clip)."""
    _, videos = _videos(hard=False, T=8, seed=50)
    cfg = TrackerConfig()
    model = weights.init_tracker(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    rng = np.random.default_rng(0)
    losses = [float(ttt.tracker_train_step(model, cfg, opt, ttt.make_tracker_batch(videos, rng, 4))
                    ["loss"]) for _ in range(15)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_aware_batch_invariants():
    """The JAX package's test_aware_batch_invariants: suppression samples
    exist (not all), enough samples carry negatives, boxes are real, padded
    negative slots are exactly zero."""
    _, videos = _videos(hard=True, n=3)
    batch = ttt.make_tracker_batch_aware(videos, np.random.default_rng(0), 64, TrackerConfig())
    sup, nv = batch["suppress"].numpy(), batch["neg_valid"].numpy()
    ba, bb = batch["boxes_a"].numpy(), batch["boxes_b"].numpy()
    assert sup.any(), "no suppression samples drawn — tier too easy"
    assert not sup.all()
    assert nv.any(axis=1).sum() >= 16, "too few samples carry negatives"
    assert (ba[:, 2] > ba[:, 0]).all() and (ba[:, 3] > ba[:, 1]).all()
    assert (bb[:, 2] >= bb[:, 0]).all() and (bb[:, 3] >= bb[:, 1]).all()
    assert (batch["neg_boxes"].numpy()[~nv] == 0).all()


def test_aware_training_reduces_loss_and_terms(hard_videos):
    """The JAX package's test_aware_training_reduces_loss_and_terms: the
    aware loss falls and both extra terms fire."""
    _, videos = hard_videos
    cfg = TrackerConfig()
    model = weights.init_tracker(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    rng = np.random.default_rng(0)
    losses, hinges, sups = [], [], []
    for _ in range(15):
        batch = ttt.make_tracker_batch_aware(videos, rng, 8, cfg)
        aux = ttt.tracker_train_step(model, cfg, opt, batch, recipe="aware")
        losses.append(float(aux["loss"]))
        hinges.append(float(aux["hinge"]))
        sups.append(float(aux["sup"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert max(hinges) > 0.0, "distractor hinge never fired"
    assert max(sups) > 0.0, "occlusion suppression never fired"


@pytest.mark.parametrize("recipe", ["pair", "aware"])
def test_train_tracker_tool_on_the_cpu(tmp_path, recipe):
    """--device cpu, a few steps: the checkpoint loads into the tracker that
    the track, stream and pipeline tools build, and differs from the seed's."""
    from vdetlib_tpu_torch.cli import train_tracker

    out = str(tmp_path / "trk.pt")
    argv = [out, "--image_hw", *map(str, HW), "--steps", "3", "--batch_size", "4",
            "--num_videos", "2", "--frames_per_video", "10", "--recipe", recipe,
            "--device", "cpu"] + (["--tier", "hard"] if recipe == "aware" else [])
    assert train_tracker.main(argv) == 0
    model = weights.init_tracker(TrackerConfig(), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_params(out, model)
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_train_tracker_tool_needs_the_card_by_default(tmp_path):
    from vdetlib_tpu_torch.cli import train_tracker

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would train on it")
    with pytest.raises((AssertionError, RuntimeError)):
        train_tracker.main([str(tmp_path / "x.pt"), "--steps", "1"])
    assert not (tmp_path / "x.pt").exists()
