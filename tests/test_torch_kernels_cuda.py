"""The hand-written CUDA kernels against their plain PyTorch versions, on a card.

At the shapes of the fused pipeline's main path (240×320 frames, the
"fastest" flow preset and the MGP dedup at the bench budget):

- kernel A (flow level), P = 32 and 255 pairs of 60×80 bf16, 4 pairs of
  120×160 and one ragged 13×37 pair, each at search/radius (5, 3) and
  (3, 1): the MGP box-shift tolerance of tests/test_mgp.py (mean < 0.05 px,
  max < 0.5 px). Both compute in float32; they differ in summation order
  and in the kernel's pre-scaled exp2.
- kernel B (grouped NMS), 256 frames of 192 slots with 30 class groups, score
  ties, duplicates, invalid and padded slots (``chip_smoke.nms_problem``, the
  smoke run's generator): keep sets identical;
- kernel C (batched NMS), the stream's 960 problems (32 frames × 30 classes)
  of 64 slots, and a ragged 7-slot case: keep sets identical;
- kernel D (sorted NMS), 1,920 problems (64 frames × 30 classes) of 512
  slots, and a 300-slot case: keep sets identical;
- kernel E (resize + normalize), 8 native 360×480 frames to 240×320 and
  240×320 frames to the pyramid's 176×240 and 304×400: abs <= 1e-3;
- kernel F (tracker scan), over the base tracker's bf16 features of a
  360×480 clip: one step (T = 2, anchors at frame 0 and 1; boxes <= 1e-3 px,
  peaks <= 1e-4, alive equal) in bf16 and float32, and a 16-step rollout
  (alive equal, live boxes < 0.1 px, live conf < 5e-3), at the default
  pools (Q = 16, P = 8) and at Q = 12, Q = 20 and P = 6.

Every test carries the ``cuda`` marker and needs a CUDA device; without one
it skips (the decision is made in a fixture, so every worker collects the
same tests). The wrappers' CPU dispatch is covered by tests/test_torch_flow.py,
tests/test_torch_nms.py and tests/test_torch_nms_batched.py.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import nms_problem
from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
from vdetlib_tpu_torch.kernels import flow as tflow
from vdetlib_tpu_torch.kernels import flow_level as kl
from vdetlib_tpu_torch.kernels import nms_batched as kc
from vdetlib_tpu_torch.kernels import nms_grouped as kb
from vdetlib_tpu_torch.kernels import nms_sorted as kd
from vdetlib_tpu_torch.kernels import preprocess as ke
from vdetlib_tpu_torch.kernels import track_scan as kf

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_nms_kernel_equals_plain_version(cuda):
    arrs = [torch.from_numpy(a).to(cuda) for a in nms_problem(256, 192, seed=0, groups=30)]
    before = kb.nms_grouped_kernel.launches
    got = kb.nms_grouped_kernel(*arrs, 0.3)
    torch.cuda.synchronize()
    assert kb.nms_grouped_kernel.launches == before + 1
    want = kb.nms_unsorted_fixpoint(arrs[0], arrs[1], arrs[2], 0.3, groups=arrs[3])
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(arrs[2].sum())


@pytest.mark.parametrize("B, N", [(960, 64), (5, 7)])
def test_batched_nms_kernel_equals_plain_version(cuda, B, N):
    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in nms_problem(B, N, seed=N))
    before = kc.nms_batched_kernel.launches
    got = kc.nms_batched_kernel(boxes, scores, valid, 0.3)
    torch.cuda.synchronize()
    assert kc.nms_batched_kernel.launches == before + 1
    assert torch.equal(got, kb.nms_unsorted_fixpoint(boxes, scores, valid, 0.3))
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("B, N", [(1920, 512), (3, 300)])
def test_sorted_nms_kernel_equals_plain_version(cuda, B, N):
    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in nms_problem(B, N, seed=N))
    before = kd.nms_sorted_kernel.launches
    got = kd.nms_sorted_kernel(boxes, scores, valid, 0.3)
    torch.cuda.synchronize()
    assert kd.nms_sorted_kernel.launches == before + 1
    assert torch.equal(got, kd.nms_sorted_greedy(boxes, scores, valid, 0.3))
    assert 0 < int(got.sum()) < int(valid.sum())


@functools.lru_cache(maxsize=None)
def _flow_video():
    return make_video(SynthConfig(num_frames=256, height=240, width=320, num_classes=4, seed=0))


@pytest.mark.parametrize("search, radius", [(5, 3), (3, 1)])
@pytest.mark.parametrize("P, H, W", [(32, 60, 80), (255, 60, 80), (4, 120, 160), (1, 13, 37)])
def test_flow_kernel_matches_plain_version_box_shifts(cuda, P, H, W, search, radius):
    """The stream's chunk and a 256-frame video at the "fastest" preset's
    60×80, the stream's partial chunk at the "fast" preset's 120×160, and one
    pair of a ragged tile (a 13×37 crop: neither side a multiple of 32);
    (5, 3) is the kernel's compiled-in window, (3, 1) its run-time path."""
    sv = _flow_video()
    pool = 2 if H == 120 else 4
    gray = tflow.to_gray(torch.from_numpy(sv.frames[:P + 1]).to(cuda))
    for _ in range(pool // 2):
        gray = tflow._avg_pool2(gray)
    # the GT boxes on the flow grid; the crop's own boxes cover its edges
    boxes = torch.from_numpy(sv.gt_boxes[:, :P].transpose(1, 0, 2).copy()).to(cuda) / pool
    if gray.shape[1:] != (H, W):
        gray = gray[:, 20:20 + H, 10:10 + W]
        boxes = torch.tensor([[[0.0, 0.0, W - 1, H - 1], [0, 0, 8, 5], [W - 9, H - 6, W - 1, H - 1],
                               [10, 3, 25, 10]]], device=cuda).expand(P, 4, 4)
    gray = gray.to(torch.bfloat16)
    i1, i2 = gray[:-1].contiguous(), gray[1:].contiguous()
    before = kl.flow_level.launches
    got = kl.flow_level(i1, i2, search=search, radius=radius)
    torch.cuda.synchronize()
    assert kl.flow_level.launches == before + 1
    want = kl._flow_level(i1, i2, search, radius)
    assert got.shape == want.shape == (P, H, W, 2)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    d = (tflow.mean_flow_in_boxes(got, boxes, valid)
         - tflow.mean_flow_in_boxes(want, boxes, valid)).abs() * pool  # full-res px
    assert float(d.mean()) < 0.05 and float(d.max()) < 0.5, (float(d.mean()), float(d.max()))
    assert float(want.abs().max()) > 0.5  # the field moves


def test_flow_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """The kernel tiles the columns, so no width is too wide for it; it
    refuses windows beyond a block's shared memory, more pairs than the grid
    holds and negative windows."""
    a = torch.zeros((2, 60, 80), dtype=torch.bfloat16, device=cuda)
    before = kl.flow_level.launches
    with pytest.raises(ValueError, match="shared memory"):
        kl.flow_level(a, a, search=200)
    with pytest.raises(ValueError):
        kl.flow_level(a, a, radius=-1)
    p = torch.zeros((kl.MAX_PAIRS + 1, 1, 1), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        kl.flow_level(p, p)
    assert kl.flow_level.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a = torch.zeros((2, 8, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        kl.flow_level(a, a)  # float32, not bf16
    with pytest.raises(ValueError):
        kl.flow_level(a.to(torch.bfloat16), a.cpu().to(torch.bfloat16))
    b = torch.zeros((1, 600, 4), device=cuda)
    s = torch.zeros((1, 600), device=cuda)
    with pytest.raises(ValueError):
        kb.nms_grouped_kernel(b, s, s.bool(), s.int(), 0.5)  # N > 512
    with pytest.raises(ValueError):
        kd.nms_sorted_kernel(b, s, s.bool(), 0.5)  # N > 512
    with pytest.raises(ValueError):
        kc.nms_batched_kernel(b[:, :129], s[:, :129], s[:, :129].bool(), 0.5)  # N > 128
    with pytest.raises(TypeError):
        kc.nms_batched_kernel(b[:, :8].double(), s[:, :8], s[:, :8].bool(), 0.5)


@pytest.mark.parametrize("src, dst", [((360, 480), (240, 320)), ((240, 320), (176, 240)),
                                      ((240, 320), (304, 400))])
def test_resize_kernel_matches_plain_version(cuda, src, dst):
    sv = make_video(SynthConfig(num_frames=8, height=src[0], width=src[1], seed=3))
    frames = torch.from_numpy(sv.frames).to(cuda)
    before = ke.fused_resize_normalize_kernel.launches
    got = ke.fused_resize_normalize_kernel(frames, dst, pixel_scale=0.5)
    torch.cuda.synchronize()
    assert ke.fused_resize_normalize_kernel.launches == before + 1
    want = ke.fused_resize_normalize(frames, dst, pixel_scale=0.5)
    assert got.shape == want.shape == (8,) + dst + (3,)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.fixture(scope="module")
def scan_inputs(cuda):
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.video.track import tracker_features
    from vdetlib_tpu_torch.weights import init_tracker

    cfg = TrackerConfig()
    trk = init_tracker(cfg, torch.Generator().manual_seed(1), device=cuda)
    sv = make_video(SynthConfig(num_frames=32, height=360, width=480, num_objects=6, seed=4))
    with torch.no_grad():
        feats = tracker_features(trk, torch.from_numpy(sv.frames[::2].copy()).to(cuda))
    return cfg, sv, feats


def _scan_both(cfg, feats, ats, boxes, dev):
    from vdetlib_tpu_torch.nn.tracker_net import extract_template

    ats = torch.as_tensor(ats, device=dev)
    boxes = torch.as_tensor(boxes, device=dev)
    args = (feats, ats, boxes, extract_template(feats[ats], boxes, cfg), cfg, 0.5)
    before = kf.track_scan_kernel.launches
    got = kf.track_scan_kernel(*args)
    torch.cuda.synchronize()
    assert kf.track_scan_kernel.launches == before + 1
    return [g.cpu() for g in got], [w.cpu() for w in kf.track_scan_plain(*args)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scan_kernel_one_step_matches_plain_version(cuda, scan_inputs, dtype):
    cfg, sv, feats = scan_inputs
    rng = np.random.default_rng(0)
    k = rng.integers(0, sv.gt_boxes.shape[0], 32)
    ats = np.repeat([0, 1], 16)
    boxes = sv.gt_boxes[k, 2 + 2 * ats] + rng.normal(0, 3, (32, 4))
    got, want = _scan_both(cfg, feats[1:3].to(dtype), ats, boxes.astype(np.float32), cuda)
    for g, w in zip(got[2::3], want[2::3]):
        assert torch.equal(g, w)
    assert max(float((g - w).abs().max()) for g, w in zip(got[0::3], want[0::3])) <= 1e-3
    assert max(float((g - w).abs().max()) for g, w in zip(got[1::3], want[1::3])) <= 1e-4


def test_scan_kernel_rollout_matches_plain_version(cuda, scan_inputs):
    cfg, sv, feats = scan_inputs
    ats = np.array([0, 3, 7, 12, 15, 9, 5, 1])
    boxes = sv.gt_boxes[np.arange(8) % sv.gt_boxes.shape[0], 2 * ats].astype(np.float32)
    got, want = _scan_both(cfg, feats, ats, boxes, cuda)
    for gb, gc, ga, wb, wc, wa in ((*got[:3], *want[:3]), (*got[3:], *want[3:])):
        assert torch.equal(ga, wa)
        assert float((gb - wb).abs()[wa].max()) < 0.1
        assert float((gc - wc).abs()[wa].max()) < 5e-3


@pytest.mark.parametrize("kw", [{"search_factor": 1.5}, {"search_factor": 2.5},
                                {"template_pool": 6}], ids=["Q12", "Q20", "P6Q12"])
def test_scan_kernel_matches_plain_version_at_other_pools(cuda, scan_inputs, kw):
    """Q and P are the kernel's arguments: one step (bounds as above) and a
    16-step rollout at a narrower and a wider search window and a smaller
    template."""
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig

    _, sv, feats = scan_inputs
    cfg = TrackerConfig(**kw)
    rng = np.random.default_rng(1)
    k = rng.integers(0, sv.gt_boxes.shape[0], 32)
    ats = np.repeat([0, 1], 16)
    boxes = sv.gt_boxes[k, 2 + 2 * ats] + rng.normal(0, 3, (32, 4))
    got, want = _scan_both(cfg, feats[1:3], ats, boxes.astype(np.float32), cuda)
    for g, w in zip(got[2::3], want[2::3]):
        assert torch.equal(g, w)
    assert max(float((g - w).abs().max()) for g, w in zip(got[0::3], want[0::3])) <= 1e-3
    assert max(float((g - w).abs().max()) for g, w in zip(got[1::3], want[1::3])) <= 1e-4
    ats = np.array([0, 3, 7, 12, 15, 9, 5, 1])
    boxes = sv.gt_boxes[np.arange(8) % sv.gt_boxes.shape[0], 2 * ats].astype(np.float32)
    got, want = _scan_both(cfg, feats, ats, boxes, cuda)
    for gb, gc, ga, wb, wc, wa in ((*got[:3], *want[:3]), (*got[3:], *want[3:])):
        assert torch.equal(ga, wa)
        assert float((gb - wb).abs()[wa].max()) < 0.1
        assert float((gc - wc).abs()[wa].max()) < 5e-3


def test_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda, scan_inputs):
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig

    cfg, sv, feats = scan_inputs
    ats = torch.zeros(1, dtype=torch.int64, device=cuda)
    box = torch.tensor([[10.0, 10.0, 60.0, 60.0]], device=cuda)
    tpl = torch.zeros((1, 8, 8, 96), device=cuda)
    with pytest.raises(ValueError):
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(num_scales=3), 0.5)
    with pytest.raises(TypeError):
        kf.track_scan_kernel(feats.half(), ats, box, tpl, cfg, 0.5)
    with pytest.raises(ValueError):
        kf.track_scan_kernel(feats, ats, box, tpl[:, :4], cfg, 0.5)
    with pytest.raises(ValueError):  # Q = 4 < P = 8
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(search_factor=0.5), 0.5)
    with pytest.raises(ValueError):  # a 32x32x96 window exceeds shared memory
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(search_factor=4.0), 0.5)
