"""Port parity: block-matching flow (the plain version of the CUDA kernel A)
and the MGP hop.

Tolerances:
- flow (one level, the "fastest" preset, and the "accurate" pyramid with
  ``flow_pair`` at 2 and 3 levels): the MGP box-shift tolerance of
  tests/test_mgp.py (mean-flow-in-box differs by < 0.05 px on average and
  < 0.5 px at most). MGP consumes only box means, and the port computes the
  cost volume in float32 where the JAX XLA path squares and box-sums the
  bf16 level in bf16, so fields are not bitwise equal;
- ``_warp_bilinear``: 1e-3 absolute on 0-255 values (float32 products).
- mean_flow_in_boxes / _propagate_hop on an identical flow field: 1e-4 px
  (integral-image sums of up to a few thousand float32 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu.kernels import flow as jflow
from vdetlib_tpu.video.mgp import _propagate_hop as j_hop
from vdetlib_tpu_torch.kernels import flow as tflow
from vdetlib_tpu_torch.kernels import flow_level as kl
from vdetlib_tpu_torch.video.mgp import _propagate_hop

torch.set_num_threads(2)

HW = (96, 128)


@pytest.fixture(scope="module")
def sv():
    return make_video(SynthConfig(num_frames=6, height=HW[0], width=HW[1], num_classes=4, seed=3))


def _shift_err(f_t, f_j, boxes, scale):
    """|box-mean shift difference| over (P, K) boxes at ``scale`` of full res."""
    b = jnp.asarray(boxes) * scale
    v = jnp.ones(b.shape[:2], bool)
    want = np.asarray(jax.vmap(jflow.mean_flow_in_boxes)(jnp.asarray(f_j), b, v))
    got = tflow.mean_flow_in_boxes(torch.from_numpy(f_t), torch.from_numpy(np.array(b)),
                                   torch.from_numpy(np.array(v))).numpy()
    return np.abs(got - want)


def test_flow_level_matches_jax_box_shifts(sv):
    gray = jflow._avg_pool2(jflow._avg_pool2(jflow.to_gray(jnp.asarray(sv.frames))))
    gray = gray.astype(jnp.bfloat16)
    i1, i2 = gray[:-1], gray[1:]
    want = np.asarray(jax.vmap(lambda a, b: jflow._flow_level(a, b, 5, 3, 0.08))(i1, i2))
    t1 = torch.from_numpy(np.array(i1.astype(jnp.float32))).to(torch.bfloat16)
    t2 = torch.from_numpy(np.array(i2.astype(jnp.float32))).to(torch.bfloat16)
    got = kl.flow_level(t1, t2, search=5, radius=3, temperature=0.08).numpy()
    assert got.shape == want.shape == (5, 24, 32, 2)
    boxes = sv.gt_boxes[:, :5].transpose(1, 0, 2)  # (P, K, 4) full-res
    d = _shift_err(got, want, boxes, 0.25)
    assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())
    # the field really moves (a zero field would pass trivially)
    assert np.abs(want).max() > 0.5


def test_flow_video_fastest_matches_jax(sv):
    want = np.asarray(jflow.flow_video(jnp.asarray(sv.frames), preset="fastest", upsample=False))
    got = tflow.flow_video(torch.from_numpy(sv.frames), preset="fastest", upsample=False).numpy()
    assert got.shape == want.shape == (5, 24, 32, 2)
    boxes = sv.gt_boxes[:, :5].transpose(1, 0, 2)
    d = _shift_err(got, want, boxes, tflow.flow_coord_scale("fastest"))
    assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())


def test_flow_video_accurate_matches_jax(sv):
    """The pyramid preset (3 float32 levels, search 3, full resolution);
    ``upsample`` does not apply to it, as in JAX; one frame gives the empty
    field."""
    want = np.asarray(jflow.flow_video(jnp.asarray(sv.frames), preset="accurate"))
    got = tflow.flow_video(torch.from_numpy(sv.frames), preset="accurate", upsample=False).numpy()
    assert got.shape == want.shape == (5,) + HW + (2,)
    boxes = sv.gt_boxes[:, :5].transpose(1, 0, 2)
    d = _shift_err(got, want, boxes, tflow.flow_coord_scale("accurate"))
    assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())
    assert np.abs(want).max() > 0.5
    one = tflow.flow_video(torch.from_numpy(sv.frames[:1]), preset="accurate")
    assert one.shape == (0,) + HW + (2,) and one.dtype == torch.float32


def test_warp_bilinear_matches_jax():
    """Edge clamping and the gathers at floor and floor + 1, on flows that
    leave the image: 1e-5 (the same float32 products)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (3, 17, 23)).astype(np.float32)
    flow = rng.normal(0, 6, (3, 17, 23, 2)).astype(np.float32)
    flow[0, :2] = 40.0  # far outside the image
    want = np.asarray(jax.vmap(jflow._warp_bilinear)(jnp.asarray(img), jnp.asarray(flow)))
    got = tflow._warp_bilinear(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-6)


@pytest.mark.parametrize("levels, hw", [(2, (27, 37)), (3, (48, 64))])
def test_flow_pair_matches_jax(sv, levels, hw):
    """The coarse-to-fine pyramid at 2 and 3 levels, one at an odd frame
    size (its coarser levels drop a row and a column)."""
    frames = sv.frames[:3, :hw[0], :hw[1]]
    gray = jflow.to_gray(jnp.asarray(frames))
    want = np.asarray(jax.vmap(lambda a, b: jflow.flow_pair(a, b, levels=levels))(
        gray[:-1], gray[1:]))
    g = torch.from_numpy(np.array(gray))
    got = tflow.flow_pair(g[:-1], g[1:], levels=levels).numpy()
    assert got.shape == want.shape == (2,) + hw + (2,)
    rng = np.random.default_rng(levels)
    xy = rng.uniform(0, [hw[1] - 12, hw[0] - 12], (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 12, (2, 6, 2))], -1).astype(np.float32)
    d = _shift_err(got, want, boxes, 1.0)
    assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())


def test_gray_pool_and_box_mean_match_jax(sv):
    g_j = np.asarray(jflow._avg_pool2(jflow.to_gray(jnp.asarray(sv.frames))))
    g_t = tflow._avg_pool2(tflow.to_gray(torch.from_numpy(sv.frames))).numpy()
    np.testing.assert_allclose(g_t, g_j, atol=1e-4, rtol=0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 23)).astype(np.float32)
    np.testing.assert_allclose(
        tflow._box_mean(torch.from_numpy(x), 3).numpy(),
        np.asarray(jflow._box_mean(jnp.asarray(x), 3)), atol=1e-5, rtol=0,
    )


@pytest.mark.parametrize("coord_scale", [1.0, 0.25])
def test_mean_flow_and_propagate_hop_match_jax(coord_scale):
    rng = np.random.default_rng(1)
    h, w = (24, 32) if coord_scale < 1 else HW
    flow = rng.normal(0, 3, (3, h, w, 2)).astype(np.float32)
    N = 20
    x1 = rng.uniform(-20, HW[1], (3, N))
    y1 = rng.uniform(-20, HW[0], (3, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, 80, (3, N)), y1 + rng.uniform(0, 80, (3, N))],
                     -1).astype(np.float32)  # some boxes leave the image
    mask = rng.uniform(size=(3, N)) > 0.3
    want = np.asarray(jax.vmap(lambda f, b, m: j_hop(f, b, m, coord_scale))(
        jnp.asarray(flow), jnp.asarray(boxes), jnp.asarray(mask)))
    got = _propagate_hop(torch.from_numpy(flow), torch.from_numpy(boxes),
                         torch.from_numpy(mask), coord_scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # invalid boxes do not move
    np.testing.assert_array_equal(got[~mask], boxes[~mask])


@pytest.mark.parametrize("search, radius", [(5, 3), (3, 1)])
@pytest.mark.parametrize("P, H, W", [(1, 60, 80), (4, 60, 80), (32, 60, 80), (63, 60, 80),
                                     (95, 60, 80), (255, 60, 80), (4, 120, 160), (1, 13, 37)])
def test_kernel_launch_plan_fits_a_block(P, H, W, search, radius):
    """The kernel's tile rows (computed here, launched on the card) fit a
    block's shared memory at every path's shape, on an H100's 132 SMs."""
    th = kl.tile_rows(P, H, W, search, radius, 132)
    assert 1 <= th <= H
    assert kl.smem_bytes(th, search, radius) <= kl.MAX_SMEM
    if P >= 32:  # the paths' full calls fill the card: at least a block per SM
        assert P * -(-W // kl.TILE_W) * -(-H // th) >= 132


def test_kernel_launch_plan_rejects_windows_beyond_shared_memory():
    assert kl.smem_bytes(1, 5, 3) < kl.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        kl.tile_rows(32, 60, 80, 200, 3, 132)


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    a = torch.rand(2, 10, 12).to(torch.bfloat16)
    b = torch.rand(2, 10, 12).to(torch.bfloat16)
    before = kl.flow_level.launches
    got = kl.flow_level(a, b)
    assert kl.flow_level.launches == before
    torch.testing.assert_close(got, kl._flow_level(a, b), atol=0, rtol=0)
    with pytest.raises(ValueError):
        kl.flow_level(a.to("meta"), b.to("meta"))
