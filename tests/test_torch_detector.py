"""Port parity: the detection step (backbone → ROI align → head → softmax →
deltas → clip) of vdetlib_tpu_torch against vdetlib_tpu, same weights.

Tolerances: at the production bf16 activations, probs within 1e-2 and
boxes within 0.5 px (bf16 rounds at different places in XLA and PyTorch:
XLA may keep excess precision between fused bf16 ops, so features differ by
a few bf16 ulps). With an f32 backbone the feature maps must agree to 1e-4
— tight enough that a padding or GroupNorm mistake (a shifted grid, a wrong
epsilon) fails it — and probs to 2e-3, boxes to 0.25 px: the head's hidden
layers stay bf16 in both (not configurable in the JAX package), and a
one-ulp flip of a bf16 hidden unit moves a delta by ~3e-4.

The random box-regression layer is scaled by 0.1 in both packages so that
its deltas have the magnitude of a trained regressor's (|d| of a few
tenths); at raw lecun-normal scale exp(dw) turns bf16 noise into pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu.nn.backbone import BackboneConfig as JBackboneConfig
from vdetlib_tpu.nn.detector import init_detector as jinit_detector
from vdetlib_tpu.nn.presets import detector_preset as jpreset
from vdetlib_tpu.video.detect import _detect_step as j_detect_step
from vdetlib_tpu_torch.nn.detector import Detector
from vdetlib_tpu_torch.nn.heads import roi_align
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.video.detect import _detect_step
from vdetlib_tpu_torch.weights import detector_state_from_flax

torch.set_num_threads(2)

HW = (96, 128)
B, R, C = 4, 16, 4


def _inputs(seed=0):
    sv = make_video(SynthConfig(num_frames=B, height=HW[0], width=HW[1], num_classes=C, seed=seed))
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-10, HW[1] - 10, (B, R))
    y1 = rng.uniform(-10, HW[0] - 10, (B, R))
    w = rng.uniform(4, 70, (B, R))
    h = rng.uniform(4, 70, (B, R))
    rois = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    return sv.frames, rois


def _pair(dtype_j, dtype_t):
    jcfg = jpreset("tiny", num_classes=C)
    jcfg = jcfg.__class__(
        num_classes=C, backbone=JBackboneConfig(
            stem_features=16, stage_sizes=(1, 1, 1), stage_features=(32, 64, 128),
            dtype=dtype_j,
        ), head_hidden=128,
    )
    jmodel, jparams = jinit_detector(jcfg, HW, max_rois=R, seed=0)
    jparams = jax.tree.map(np.asarray, jparams)
    bbox = jparams["params"]["head"]["bbox"]
    bbox["kernel"] = bbox["kernel"] * np.float32(0.1)
    tmodel = Detector(detector_preset("tiny", num_classes=C, dtype=dtype_t))
    tmodel.load_state_dict(detector_state_from_flax(jparams))
    return jmodel, jparams, tmodel.eval()


@pytest.mark.parametrize(
    "dtypes, p_tol, b_tol",
    [((jnp.bfloat16, torch.bfloat16), 1e-2, 0.5), ((jnp.float32, torch.float32), 2e-3, 0.25)],
    ids=["bf16", "f32"],
)
def test_detect_step_matches_jax(dtypes, p_tol, b_tol):
    jmodel, jparams, tmodel = _pair(*dtypes)
    frames, rois = _inputs()
    jp, jb = j_detect_step(jmodel, jparams, jnp.asarray(frames), jnp.asarray(rois), True)
    with torch.no_grad():
        tp, tb = _detect_step(tmodel, torch.from_numpy(frames), torch.from_numpy(rois), True)
    jp, jb = np.asarray(jp), np.asarray(jb)
    assert tp.shape == jp.shape and tb.shape == jb.shape
    dp = np.abs(tp.numpy() - jp).max()
    db = np.abs(tb.numpy() - jb).max()
    assert dp < p_tol and db < b_tol, (dp, db)
    if dtypes[1] == torch.float32:
        from vdetlib_tpu.nn.detector import preprocess_images

        x = preprocess_images(jnp.asarray(frames), jmodel.config)
        jf = np.asarray(jmodel.apply(jparams, x, method=jmodel.features))
        with torch.no_grad():
            tf = tmodel.backbone(torch.from_numpy(np.array(x))).numpy()
        np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=0)


def test_roi_align_matches_jax():
    """Separable bilinear ROI align, f32 and bf16 compute, vs the JAX form (1e-5 / 1e-2)."""
    from vdetlib_tpu.nn.heads import roi_align as jroi_align

    rng = np.random.default_rng(3)
    feats = rng.normal(size=(6, 8, 16)).astype(np.float32)
    boxes = rng.uniform(-8, 130, (5, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(1, 60, (5, 2))
    for cdt_j, cdt_t, tol in ((None, None, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = np.asarray(jroi_align(jnp.asarray(feats), jnp.asarray(boxes), 16, pool=7,
                                     compute_dtype=cdt_j))
        got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), 16, pool=7,
                        compute_dtype=cdt_t).float().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
