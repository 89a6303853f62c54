"""Port parity: detector training (vdetlib_tpu_torch/nn/train.py, the
train_detector tool, train-state checkpoints and the optax-state converter)
against vdetlib_tpu/nn/train.py, on the CPU.

At the tiny preset, 96×128, batch 2 and R = 16 (tests/test_detector.py's
size). Tolerances:

- batches: images, ROIs and labels identical for one numpy seed; bbox
  targets within 1 ulp (XLA's and torch's float32 log may differ in the
  last bit);
- one step at float32 (backbone and head, both packages): the loss within
  1e-5 relative, every gradient within 1e-4 of its tensor's largest
  magnitude. The step itself is not compared on real gradients: Adam's
  first update is about lr·sign(g), so a gradient near 0 that differs in
  sign moves its parameter by 2·lr. The optimizer is held to optax on
  identical gradients instead (1e-6 relative over 30 cosine steps, some
  above the clip norm);
- at the production bf16 the loss within 2e-2 relative (the head's hidden
  layers round at bf16 in different places in XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig as JSynthConfig
from vdetlib_tpu.data.synth import annot_proto as jannot_proto
from vdetlib_tpu.data.synth import hard_config as jhard_config
from vdetlib_tpu.data.synth import make_video as jmake_video
from vdetlib_tpu.geometry.boxes import encode_deltas as jencode_deltas
from vdetlib_tpu.nn.backbone import Backbone as JBackbone
from vdetlib_tpu.nn.backbone import BackboneConfig as JBackboneConfig
from vdetlib_tpu.nn.detector import Detector as JDetector
from vdetlib_tpu.nn.detector import init_detector as jinit_detector
from vdetlib_tpu.nn.detector import preprocess_images as jpreprocess
from vdetlib_tpu.nn.heads import RCNNHead as JRCNNHead
from vdetlib_tpu.nn.presets import detector_preset as jpreset
from vdetlib_tpu.nn import train as jtrain
from vdetlib_tpu_torch import weights
from vdetlib_tpu_torch.data.synth import SynthConfig, annot_proto, hard_config, make_video
from vdetlib_tpu_torch.geometry.boxes import encode_deltas
from vdetlib_tpu_torch.nn import train as ttrain
from vdetlib_tpu_torch.nn.detector import Detector
from vdetlib_tpu_torch.nn.heads import RCNNHead
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.pipeline.checkpoint import load_params, load_train_state, \
    save_train_state
from tests.torch_train_common import assert_grads_close

torch.set_num_threads(2)

HW = (96, 128)
B, R, C = 2, 16, 4


@dataclasses.dataclass
class Opts:
    batch_size: int = B
    max_rois: int = R
    augment: bool = False


def _video(hard=False, seed=1, T=8):
    kw = dict(num_frames=T, height=HW[0], width=HW[1], num_classes=C, seed=seed)
    if hard:
        return jmake_video(jhard_config(**kw)), make_video(hard_config(**kw))
    return jmake_video(JSynthConfig(**kw)), make_video(SynthConfig(**kw))


class _F32Detector(JDetector):
    """The JAX detector with its head at float32 (the package fixes it at bf16)."""

    def setup(self):
        self.backbone = JBackbone(self.config.backbone)
        self.head = JRCNNHead(num_classes=self.config.num_classes,
                              hidden=self.config.head_hidden, dtype=jnp.float32)


def _torch_detector(dtype):
    model = Detector(detector_preset("tiny", num_classes=C, dtype=dtype))
    if dtype == torch.float32:
        model.head = RCNNHead(model.head.fc0.in_features, C, hidden=128, dtype=torch.float32)
    return model


def _pair(dtype="f32"):
    """A JAX tiny detector and the port's, same weights; float32 throughout
    (backbone and head) or the production bf16."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = dataclasses.replace(jpreset("tiny", num_classes=C), backbone=JBackboneConfig(
        stem_features=16, stage_sizes=(1, 1, 1), stage_features=(32, 64, 128), dtype=jdt))
    if dtype == "f32":
        jmodel = _F32Detector(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)),
                                       jnp.zeros((1, R, 4)))
    else:
        jmodel, jparams = jinit_detector(jcfg, HW, max_rois=R, seed=0)
    jparams = jax.tree.map(np.asarray, jparams)
    tmodel = _torch_detector(tdt)
    tmodel.load_state_dict(weights.detector_state_from_flax(jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("f32")


def _batches(hard, augment, seed=0, n=1):
    jsv, tsv = _video(hard)
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    opts = Opts(augment=augment)
    return [(jtrain.make_training_batch(jsv, jrng, opts, C),
             ttrain.make_training_batch(tsv, trng, opts, C)) for _ in range(n)]


# ---------------------------------------------------------------- helpers


def test_encode_deltas_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, (64, 4)).astype(np.float32)
    src[:, 2:] = src[:, :2] + rng.uniform(-2, 60, (64, 2))  # some degenerate (eps) boxes
    dst = src + rng.normal(0, 5, (64, 4)).astype(np.float32)
    want = np.asarray(jencode_deltas(jnp.asarray(src), jnp.asarray(dst)))
    got = encode_deltas(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    want = np.asarray(jencode_deltas(jnp.asarray(src), jnp.asarray(dst), offset=0.0, eps=1e-3))
    got = encode_deltas(torch.from_numpy(src), torch.from_numpy(dst), offset=0.0, eps=1e-3)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
def test_annot_proto_matches_jax(hard):
    jsv, tsv = _video(hard, T=12)
    assert annot_proto(tsv) == jannot_proto(jsv)
    names = tuple(f"c{i}" for i in range(C))
    assert annot_proto(tsv, names) == jannot_proto(jsv, names)


def test_assign_targets_matches_jax():
    """First maximum on IoU ties (two identical gt boxes), masked gt at -1,
    padded ROI slots at -1, background below 0.5."""
    rng = np.random.default_rng(1)
    rois = rng.uniform(0, 90, (3, 20, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(4, 50, (3, 20, 2))
    gt = rng.uniform(0, 90, (3, 5, 4)).astype(np.float32)
    gt[..., 2:] = gt[..., :2] + rng.uniform(8, 50, (3, 5, 2))
    gt[:, 3] = gt[:, 1]  # a tie
    rois[:, :5] = gt + rng.normal(0, 2, gt.shape).astype(np.float32)
    rois[:, 5] = gt[:, 1]  # exactly on the tied pair
    roi_mask = rng.uniform(size=(3, 20)) < 0.8
    cls = rng.integers(1, C, (3, 5)).astype(np.int32)
    gt_m = rng.uniform(size=(3, 5)) < 0.8
    gt_m[:, 1] = gt_m[:, 3] = True
    jl, jt = jax.vmap(jtrain.assign_targets)(*map(jnp.asarray, (rois, roi_mask, gt, cls, gt_m)))
    tl, tt = ttrain.assign_targets(*map(torch.from_numpy, (rois, roi_mask, gt, cls, gt_m)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32
    np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), maxulp=1)
    assert (tl.numpy() > 0).sum() >= 10 and (tl.numpy() == 0).any() and (tl.numpy() == -1).any()


def test_detector_loss_matches_jax():
    rng = np.random.default_rng(2)
    scores = rng.normal(0, 2, (2, 16, C)).astype(np.float32)
    deltas = rng.normal(0, 1.5, (2, 16, C, 4)).astype(np.float32)
    labels = rng.integers(-1, C, (2, 16)).astype(np.int32)
    targets = rng.normal(0, 1, (2, 16, 4)).astype(np.float32)
    jl, jaux = jtrain.detector_loss(*map(jnp.asarray, (scores, deltas, labels, targets)))
    tl, taux = ttrain.detector_loss(*map(torch.from_numpy, (scores, deltas, labels, targets)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("cls_loss", "reg_loss", "n_fg"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)
    # padding only: the JAX package's test_loss_ignores_padding
    lab = torch.tensor([[1, 0, -1, -1], [2, -1, -1, -1]])
    _, aux = ttrain.detector_loss(torch.zeros(2, 4, 3), torch.zeros(2, 4, 3, 4), lab,
                                  torch.zeros(2, 4, 4))
    np.testing.assert_allclose(float(aux["cls_loss"]), np.log(3), rtol=1e-6)
    assert float(aux["reg_loss"]) == 0.0


# ---------------------------------------------------------------- batches


@pytest.mark.parametrize("hard, augment", [(False, False), (False, True), (True, True)],
                         ids=["plain", "augment", "hard-augment"])
def test_training_batch_matches_jax(hard, augment):
    for jb, tb in _batches(hard, augment, n=3):
        for k in ("images_u8", "rois", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        np.testing.assert_array_max_ulp(tb["bbox_targets"].numpy(),
                                        np.asarray(jb["bbox_targets"]), maxulp=1)
        assert tb["labels"].dtype == torch.int32 and tb["images_u8"].dtype == torch.uint8
        assert (tb["labels"].numpy() > 0).any()


# ---------------------------------------------------------------- one step


def _jax_loss(jmodel, params, batch):
    images = jpreprocess(batch["images_u8"], jmodel.config)
    scores, deltas = jmodel.apply(params, images, batch["rois"], train=True)
    return jtrain.detector_loss(scores, deltas, batch["labels"], batch["bbox_targets"])


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss, argnums=1, has_aux=True),
                              static_argnums=0)


def _jax_loss_and_grads(jmodel, jparams, batch):
    (loss, aux), grads = _jax_value_and_grad(jmodel, jax.tree.map(jnp.asarray, jparams), batch)
    return float(loss), aux, weights.detector_state_from_flax(jax.tree.map(np.asarray, grads))


def _torch_loss_and_grads(tmodel, batch):
    tmodel.zero_grad(set_to_none=True)
    loss, aux = ttrain.loss_and_terms(tmodel, batch)
    loss.backward()
    return float(loss.detach()), aux, {n: p.grad.clone() for n, p in tmodel.named_parameters()}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_one_step_loss_and_grads_match_jax(f32_pair, augment):
    jmodel, jparams, tmodel = f32_pair
    (jb, tb), = _batches(hard=False, augment=augment, seed=3)
    jl, jaux, jg = _jax_loss_and_grads(jmodel, jparams, jb)
    tl, taux, tg = _torch_loss_and_grads(tmodel, tb)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in ("cls_loss", "reg_loss"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5)
    assert_grads_close(tg, jg)


def test_bf16_loss_matches_jax_loosely():
    jmodel, jparams, tmodel = _pair("bf16")
    (jb, tb), = _batches(hard=False, augment=True, seed=4)
    jl, _ = jax.jit(_jax_loss, static_argnums=0)(jmodel, jax.tree.map(jnp.asarray, jparams), jb)
    with torch.no_grad():
        tl, _ = ttrain.loss_and_terms(tmodel, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


# ---------------------------------------------------------------- optimizer


def _grad_stream(shapes, n, seed=5):
    """Seeded gradients whose global norm ranges over 0.5–40 (the clip at 10)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        target = [0.5, 4.0, 15.0, 40.0][i % 4]
        out.append([x * np.float32(target / norm) for x in g])
    return out


@pytest.mark.parametrize("schedule, max_norm", [("cosine", 10.0), ("const", 5.0)])
def test_optimizer_matches_optax(schedule, max_norm):
    """30 updates of identical gradients: optax's chain (clip, adamw with its
    schedule; JAX's make_optimizer, or the tracker's clip 5 + adamw(lr)) and
    the port's ClippedAdamW give the same parameters at 1e-6 relative."""
    steps, lr = 30, 3e-3
    shapes = [(7, 5), (5,), (3, 3, 2, 4)]
    p0 = [np.random.default_rng(6).normal(size=s).astype(np.float32) for s in shapes]
    if max_norm == 10.0:
        tx = jtrain.make_optimizer(lr, schedule=schedule, total_steps=steps)
    else:
        tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(lr))
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ttrain.make_optimizer(tp, lr, schedule=schedule, total_steps=steps, max_norm=max_norm)
    for k, g in enumerate(_grad_stream(shapes, steps)):
        upd, js = update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        assert opt.updates_made() == k + 1
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # the schedule reached its floor: lr/100 at total_steps
    if schedule == "cosine":
        sched = optax.warmup_cosine_decay_schedule(lr / 10, lr, max(1, steps // 20), steps,
                                                   lr / 100)
        for k in range(steps + 2):
            # optax evaluates the cosine in float32 (1 + cos cancels near the end)
            np.testing.assert_allclose(ttrain.lr_at(k, lr, "cosine", steps), float(sched(k)),
                                       rtol=1e-5)


def test_unknown_or_short_schedule_refused():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError):
        ttrain.make_optimizer(p, 1e-3, schedule="cosine")  # needs total_steps
    with pytest.raises(ValueError):
        ttrain.make_optimizer(p, 1e-3, schedule="linear", total_steps=10)


def test_adam_state_from_optax(f32_pair):
    """JAX's make_optimizer state after three updates, carried into the
    port's optimizer: the fourth update of identical gradients gives the
    same parameters in both (the conv and dense transposes of mu and nu)."""
    _, jparams, _ = f32_pair
    tmodel = _torch_detector(torch.float32)
    lr = 1e-3
    tx = jtrain.make_optimizer(lr, schedule="cosine", total_steps=40)
    update = jax.jit(tx.update)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = tx.init(jp)
    leaves, tree = jax.tree.flatten(jp)
    grads = _grad_stream([x.shape for x in leaves], 4, seed=8)
    for g in grads[:3]:
        upd, js = update(jax.tree.unflatten(tree, [jnp.asarray(x) for x in g]), js, jp)
        jp = optax.apply_updates(jp, upd)
    jp_np = jax.tree.map(np.asarray, jp)
    tmodel.load_state_dict(weights.detector_state_from_flax(jp_np))
    opt = ttrain.make_optimizer(tmodel.parameters(), lr, schedule="cosine", total_steps=40)
    adam = js[1][0]
    opt.load_state_dict(weights.adam_state_from_optax(
        adam.count, jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        weights.detector_state_from_flax, tmodel, opt))
    assert opt.updates_made() == 3
    upd, js = update(jax.tree.unflatten(tree, [jnp.asarray(x) for x in grads[3]]), js, jp)
    jp = optax.apply_updates(jp, upd)
    g4 = weights.detector_state_from_flax(jax.tree.unflatten(tree, grads[3]))
    for n, p in tmodel.named_parameters():
        p.grad = g4[n].clone()
    opt.step()
    want = weights.detector_state_from_flax(jax.tree.map(np.asarray, jp))
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=n)


# ---------------------------------------------------------------- state and behaviour


def _tiny_state(seed=0, total_steps=20):
    model = weights.init_detector(detector_preset("tiny", num_classes=C),
                                  torch.Generator().manual_seed(seed), device="cpu")
    opt = ttrain.make_optimizer(model.parameters(), 1e-3, schedule="cosine",
                                total_steps=total_steps)
    return ttrain.init_train_state(model, opt)


def test_train_state_resume_is_bit_for_bit(tmp_path):
    """Save after two steps; the uninterrupted third step and the third step
    of a fresh state loaded from the file are equal bit for bit."""
    batches = [tb for _, tb in _batches(hard=False, augment=True, seed=9, n=3)]
    state = _tiny_state()
    for b in batches[:2]:
        ttrain.train_step(state.model, state.opt, b)
        state.step += 1
    path = str(tmp_path / "state.pt")
    save_train_state(path, state)
    want_aux = ttrain.train_step(state.model, state.opt, batches[2])
    fresh = _tiny_state(seed=7)
    got = load_train_state(path, fresh)
    assert got.step == 2 and got.opt.updates_made() == 2
    got_aux = ttrain.train_step(got.model, got.opt, batches[2])
    assert torch.equal(got_aux["loss"], want_aux["loss"])
    for (n, a), (_, b) in zip(got.model.state_dict().items(), state.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = got.opt.state_dict()["state"], state.opt.state_dict()["state"]
    for i in sb:
        for k in sb[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_train_state_load_refuses_a_mismatch(tmp_path):
    path = str(tmp_path / "state.pt")
    save_train_state(path, _tiny_state())
    other = weights.init_detector(detector_preset("tiny", num_classes=C + 1), device="cpu")
    with pytest.raises(ValueError, match="head"):
        load_train_state(path, ttrain.TrainState(other, ttrain.make_optimizer(
            other.parameters()), 0))
    with pytest.raises(ValueError, match="not a"):
        load_params(path)


def test_training_reduces_loss():
    """The JAX package's test_training_reduces_loss: ten steps of the tiny
    detector at a constant lr cut the loss by 20%."""
    sv = make_video(SynthConfig(num_frames=8, height=HW[0], width=HW[1], seed=1))
    model = weights.init_detector(detector_preset("tiny", num_classes=C), device="cpu")
    opt = ttrain.make_optimizer(model.parameters(), 1e-3)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(10):
        batch = ttrain.make_training_batch(sv, rng, Opts(), C)
        losses.append(float(ttrain.train_step(model, opt, batch)["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_cosine_schedule_optimizer():
    """The JAX package's test_cosine_schedule_optimizer: the cosine schedule
    trains and decays the lr (warmup of one step at total 20, lr/100 at 20)."""
    sv = make_video(SynthConfig(num_frames=8, height=HW[0], width=HW[1], seed=1))
    state = _tiny_state(total_steps=20)
    rng = np.random.default_rng(0)
    for _ in range(3):
        aux = ttrain.train_step(state.model, state.opt, ttrain.make_training_batch(
            sv, rng, Opts(), C))
    assert np.isfinite(float(aux["loss"]))
    assert state.opt.param_groups[0]["lr"] == ttrain.lr_at(2, 1e-3, "cosine", 20)
    assert ttrain.lr_at(0, 1e-3, "cosine", 20) < ttrain.lr_at(1, 1e-3, "cosine", 20)
    np.testing.assert_allclose(ttrain.lr_at(20, 1e-3, "cosine", 20), 1e-5, rtol=1e-12)


# ---------------------------------------------------------------- the tool


def test_train_detector_tool_on_the_cpu(tmp_path, capsys):
    """--device cpu: a few steps with two evals; the best step's checkpoint
    loads into the pipeline's detector; the held-out eval equals a direct call."""
    from vdetlib_tpu_torch.cli import train_detector

    out = str(tmp_path / "det.pt")
    argv = [out, "--model", "tiny", "--image_hw", *map(str, HW), "--steps", "4",
            "--batch_size", "2", "--max_rois", "16", "--num_videos", "2",
            "--frames_per_video", "6", "--eval_every", "2", "--eval_videos", "1",
            "--lr_schedule", "cosine", "--device", "cpu"]
    assert train_detector.main(argv) == 0
    text = capsys.readouterr().out
    assert "best held-out mAP@0.5" in text and "saved weights" in text
    model = weights.init_detector(detector_preset("tiny", num_classes=C),
                                  torch.Generator().manual_seed(3), device="cpu")
    load_params(out, model)
    heldout = [make_video(SynthConfig(num_frames=6, height=HW[0], width=HW[1], num_classes=C,
                                      seed=10_000))]
    m, per_class = train_detector.evaluate_heldout_map(model, heldout, C, 16)
    assert 0.0 <= m <= 1.0 and set(per_class) <= set(range(1, C))


def test_heldout_map_matches_jax(f32_pair):
    """evaluate_heldout_map of the same float32 weights on the same held-out
    videos: the same mAP in both packages (per-class AP within 1e-6)."""
    from vdetlib_tpu.cli.train_detector import evaluate_heldout_map as jeval
    from vdetlib_tpu_torch.cli.train_detector import evaluate_heldout_map

    jmodel, jparams, tmodel = f32_pair
    cfgs = [dict(num_frames=6, height=HW[0], width=HW[1], num_classes=C, seed=10_000 + i)
            for i in range(2)]
    jm, jper = jeval(jmodel, jax.tree.map(jnp.asarray, jparams),
                     [jmake_video(JSynthConfig(**c)) for c in cfgs], C, R)
    tm, tper = evaluate_heldout_map(tmodel.eval(), [make_video(SynthConfig(**c)) for c in cfgs],
                                    C, R)
    assert jm > 0
    assert set(tper) == set(jper)
    np.testing.assert_allclose(tm, jm, atol=1e-6)


def test_train_detector_tool_needs_the_card_by_default(tmp_path):
    from vdetlib_tpu_torch.cli import train_detector

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would train on it")
    with pytest.raises((AssertionError, RuntimeError)):
        train_detector.main([str(tmp_path / "x.pt"), "--steps", "1", "--image_hw", "96", "128"])
    assert not (tmp_path / "x.pt").exists()
