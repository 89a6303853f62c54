"""The weight converter: Flax parameter trees → torch state_dicts.

Exact: every converted tensor has the shape the torch module expects
(``load_state_dict(strict=True)``), the parameter counts agree, and values
are the Flax values transposed (HWIO → OIHW for convs, (in, out) → (out, in)
for dense layers). The ``base`` preset is checked from shapes alone
(``jax.eval_shape``), so no full-width JAX initialisation runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.nn.detector import Detector as JDetector
from vdetlib_tpu.nn.detector import init_detector as j_init_detector
from vdetlib_tpu.nn.presets import detector_preset as jpreset
from vdetlib_tpu.video.track import init_tracker as j_init_tracker
from vdetlib_tpu_torch.nn.detector import Detector
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet
from vdetlib_tpu_torch.weights import (
    detector_state_from_flax,
    init_detector,
    init_tracker,
    tracker_state_from_flax,
)

torch.set_num_threads(2)


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def test_tiny_detector_converts_exactly():
    _, jparams = j_init_detector(jpreset("tiny", num_classes=4), (96, 128), max_rois=8, seed=0)
    p = jax.tree.map(np.asarray, jparams)
    sd = detector_state_from_flax(p)
    model = Detector(detector_preset("tiny", num_classes=4))
    model.load_state_dict(sd, strict=True)
    assert sum(v.numel() for v in model.state_dict().values()) == _count(p)
    np.testing.assert_array_equal(
        model.backbone.stem.weight.detach().numpy(),
        p["params"]["backbone"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.head.fc0.weight.detach().numpy(), p["params"]["head"]["Dense_0"]["kernel"].T)


@pytest.mark.parametrize("preset", ["base", "small"])
def test_full_width_detector_shapes(preset):
    jcfg = jpreset(preset, num_classes=31)
    shapes = jax.eval_shape(JDetector(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 240, 320, 3)), jnp.zeros((1, 64, 4)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = Detector(detector_preset(preset, num_classes=31))
    model.load_state_dict(detector_state_from_flax(zeros), strict=True)
    assert sum(v.numel() for v in model.state_dict().values()) == _count(shapes)
    if preset == "base":
        assert tuple(shapes["params"]["head"]["Dense_0"]["kernel"].shape) == (25088, 1024)
        assert model.head.fc0.weight.shape == (1024, 25088)


def test_tracker_converts_exactly():
    _, jparams = j_init_tracker(jtn.TrackerConfig(), image_hw=(96, 128), seed=0)
    p = jax.tree.map(np.asarray, jparams)
    model = TrackerNet(TrackerConfig())
    model.load_state_dict(tracker_state_from_flax(p), strict=True)
    assert sum(v.numel() for v in model.state_dict().values()) == _count(p)
    np.testing.assert_array_equal(model.out.bias.detach().numpy(), p["params"]["Conv_3"]["bias"])


def test_seeded_init_matches_converted_shapes_and_is_reproducible():
    cfg = detector_preset("tiny", num_classes=4)
    a = init_detector(cfg, torch.Generator().manual_seed(3))
    b = init_detector(cfg, torch.Generator().manual_seed(3))
    c = init_detector(cfg, torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.head.fc0.weight, c.head.fc0.weight)
    # lecun-normal fan-in: std ~ 1/sqrt(fan_in), biases zero, GN scales one
    w = a.head.fc0.weight.detach()
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.05
    assert float(a.head.fc0.bias.detach().abs().max()) == 0.0
    assert float((a.backbone.stem_gn.weight.detach() - 1).abs().max()) == 0.0
    t = init_tracker(TrackerConfig(), torch.Generator().manual_seed(0))
    _, jparams = j_init_tracker(jtn.TrackerConfig(), image_hw=(96, 128), seed=0)
    ref = tracker_state_from_flax(jax.tree.map(np.asarray, jparams))
    assert {k: v.shape for k, v in t.state_dict().items()} == {k: v.shape for k, v in ref.items()}
