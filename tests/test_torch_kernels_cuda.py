"""The hand-written CUDA kernels against their plain PyTorch versions, on a card.

At the shapes of the fused pipeline's main path (240×320 frames, the
"fastest" flow preset and the MGP dedup at the bench budget):

- kernel A (flow level), P = 32 and 255 pairs of 60×80 bf16, 4 pairs of
  120×160 and one ragged 13×37 pair, each at search/radius (5, 3) and
  (3, 1), and the staged MGP's 95 pairs of 90×120; its float32 path at the
  "accurate" pyramid's level shapes for 240×320 frames (63 pairs of
  240×320, 120×160 and 60×80, 255 of 60×80, 3 of 240×320) at (3, 3),
  (5, 3) and (2, 1): the MGP box-shift tolerance of tests/test_mgp.py
  (mean < 0.05 px, max < 0.5 px). Both compute in float32; they differ in
  summation order and in the kernel's pre-scaled exp2. ``flow_video`` of
  one frame launches nothing; the "accurate" ``flow_video`` launches A
  once a level and agrees with the CPU's;
- kernel B (grouped NMS), 256 frames of 192 slots with 30 class groups, score
  ties, duplicates, invalid and padded slots (``chip_smoke.nms_problem``, the
  smoke run's generator): keep sets identical; and the cases its sorted,
  tiled build and its division filter risk: N = 1, 31, 33, 129 and 512, one
  group and a group a slot, ids -7 and 2^30, nothing valid, a suppression
  chain of 95 links across words, an IoU exactly at the threshold, and
  thresholds 0 and -0.1; the stream's 32 × 192 through ``batched_nms``;
  above its 512 slots (the fused dedup's 576 at ``mgp_window`` 4)
  ``nms_grouped`` takes the fixpoint and launches no B, and above D's
  8,192 ``batched_nms`` (2 × 8,200) takes it and launches no D: keep sets
  identical to the CPU's plain version;
- kernel C (batched NMS), the stream's 960 problems (32 frames × 30 classes)
  of 64 slots, and a ragged 7-slot case: keep sets identical; and the same
  edge cases up to 128 slots, at 3 and 5 problems;
- kernel D (sorted NMS, one launch a call), 1,920 problems (64 frames × 30
  classes) of 512 slots, and a 300-slot case: keep sets identical; and the
  cases its one-launch design (compaction, a warp sort at <= 32 valid slots,
  a bitonic sort above, a walk in chunks of 32) risks: N = 1, 31, 33, 511,
  513, 1024, 2048 and its limit, nothing valid, every slot valid in one
  cluster, a suppression chain of 95 links, an IoU exactly at the
  threshold, thresholds 0 and -0.1, scores with ties, ±0.0, NaN and ±inf,
  and the frame-NMS tool's sparse problems; ``batched_nms`` at 1,024 slots
  launches D once; the profiler sees one device kernel a call;
- kernel E (resize + normalize), 8 native 360×480 frames to 240×320 and
  240×320 frames to the pyramid's 176×240 and 304×400, and edge cases (1×1,
  7×13 ↔ 5×9, a batch at an odd byte offset, 1 and 13 frames, another mean
  and scale): abs <= 1e-3, one launch each;
- kernel F (tracker scan), over the base tracker's bf16 features of a
  360×480 clip: one step (T = 2, anchors at frame 0 and 1; boxes <= 1e-3 px,
  peaks <= 1e-4, alive equal) in bf16 and float32, and a 16-step rollout
  (alive equal, live boxes < 0.1 px, live conf < 5e-3), at the default
  pools (Q = 16, P = 8) and at Q = 12, Q = 20 and P = 6; and the cases the
  redesign (clusters of blocks a lane, 16-byte channel vectors, one partial
  response where P do not fit) adds or risks: A = 1 and 3, anchors at the
  first and last frame, boxes across the frame's edge, lanes that die, T = 1,
  C = 36 and 100, float32 features at Q = 20 and 23 and at C = 38, and
  A = 17 and 34 (clusters of 2 and of 1 block a lane); ``track_batch``
  launches F only where ``kernel_takes(cfg) and snap is None``: with
  snapping, EMA templates or three scales it runs the plain scan on the
  card, equal to the CPU's within the rollout bounds;
- kernel G (seq-NMS, one launch a call), against the plain version on the
  card: the sweep's 30 lanes × 64 slots at T = 288 and 480 with 100 paths,
  N = 1, 17, 63 and 64, T = 1 and a long video of T = 3,200; tied scores
  and tied dp values, lanes with every slot masked, budgets under the
  paths available, "avg" and "max",
  both offsets: path ids and -1 suppressions exactly, scores exactly under
  "max" and within 1e-6 relative under "avg"; against tests/oracle/
  seq_nms.py on a small problem; one G launch a call (the profiler sees
  one ``seq_nms_kernel``); the stream's video-end shape (30, 282, 900)
  takes the plain version (no launch, ``plain_calls`` counts it), equal
  to the CPU's; the wrapper refuses what G does not take.

Every test carries the ``cuda`` marker and needs a CUDA device; without one
it skips (the decision is made in a fixture, so every worker collects the
same tests). The wrappers' CPU dispatch is covered by tests/test_torch_flow.py,
tests/test_torch_nms.py and tests/test_torch_nms_batched.py.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import nms_problem, seq_nms_equal, seq_nms_problem
from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
from vdetlib_tpu_torch.kernels import flow as tflow
from vdetlib_tpu_torch.kernels import flow_level as kl
from vdetlib_tpu_torch.kernels import nms_batched as kc
from vdetlib_tpu_torch.kernels import nms_grouped as kb
from vdetlib_tpu_torch.kernels import nms_sorted as kd
from vdetlib_tpu_torch.kernels import preprocess as ke
from vdetlib_tpu_torch.kernels import seq_nms as kg
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


def _nms_edge_problem(case):
    """(boxes, scores, valid, groups, thresh) of one edge case, numpy."""
    rng = np.random.default_rng(sum(map(ord, case)))
    N, thresh = {"N1": 1, "N31": 31, "N33": 33, "N127": 127, "N128": 128, "N129": 129,
                 "N511": 511, "N512": 512, "N513": 513, "N1024": 1024, "N2048": 2048,
                 "Nmax": kd.MAX_SLOTS}.get(case, 96), 0.3
    boxes, scores, valid, groups = nms_problem(3, N, seed=N, groups=5)
    if case == "one_group":
        groups[:] = 4
    elif case == "group_per_slot":
        groups[:] = np.arange(N, dtype=np.int32)
    elif case == "ids":  # negative and large ids
        groups = np.where(groups % 2 == 0, np.int32(-7), np.int32(2**30)).astype(np.int32)
    elif case == "all_invalid":
        valid[:] = False
    elif case == "chain":
        # a staircase of 96 boxes, 3 px apart, scores falling, at scattered
        # slots: each box overlaps the next by IoU 8/14 > 0.5 and the one
        # after by 5/17 < 0.5, so the suppression chain is 95 links long
        # and crosses every 32-slot word
        perm = rng.permutation(N)
        k = np.arange(N, dtype=np.float32)
        stair = np.stack([3 * k, 0 * k, 3 * k + 10, 0 * k + 10], 1)
        boxes = np.broadcast_to(stair[perm], (3, N, 4)).copy()
        scores = np.broadcast_to((1 - k / 128)[perm], (3, N)).astype(np.float32).copy()
        valid[:] = True
        groups[:] = 1
        thresh = 0.5
    elif case == "at_thresh":
        # IoU 100/200 = 0.5 exactly in float32 (offset 1): at thresh 0.5
        # neither box suppresses the other; the third, a copy of the first
        # with a lower score, is suppressed
        boxes = np.array([[[0, 0, 9, 9], [0, 0, 9, 19], [0, 0, 9, 9]]] * 3, np.float32)
        scores = np.array([[0.9, 0.8, 0.7]] * 3, np.float32)
        valid = np.ones((3, 3), bool)
        groups = np.zeros((3, 3), np.int32)
        thresh = 0.5
    elif case == "one_cluster":  # every slot valid, all around one box
        boxes = (np.array([40, 30, 120, 90], np.float32)
                 + rng.normal(0, 2, (3, N, 4))).astype(np.float32)
        valid[:] = True
    elif case == "special_scores":  # ties, ±0.0, NaN and ±inf among valid slots
        pick = rng.integers(0, 6, (3, N))
        scores = np.array([0.5, 0.0, -0.0, np.nan, np.inf, -np.inf], np.float32)[pick]
        valid[:] = rng.uniform(size=(3, N)) > 0.1
    elif case == "thresh0":
        thresh = 0.0
    elif case == "thresh-0.1":
        thresh = -0.1
    return boxes, scores, valid, groups, thresh


GROUPED_EDGES = ["N1", "N31", "N33", "N129", "N512", "one_group", "group_per_slot", "ids",
                 "all_invalid", "chain", "at_thresh", "thresh0", "thresh-0.1"]
BATCHED_EDGES = ["N1", "N31", "N33", "N127", "N128", "all_invalid", "chain", "at_thresh",
                 "thresh0", "thresh-0.1"]


@pytest.mark.parametrize("case", GROUPED_EDGES)
def test_grouped_nms_kernel_edge_cases(cuda, case):
    """Kernel B's keep sets equal the plain version's: sizes around a word
    and the limit, one group and a group a slot, any int32 ids, nothing
    valid, a chain longer than 32, an IoU exactly at the threshold, and
    thresholds 0 and below (the zero-intersection shortcut's edge)."""
    *problem, thresh = _nms_edge_problem(case)
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in problem]
    before = kb.nms_grouped_kernel.launches
    got = kb.nms_grouped_kernel(*arrs, thresh)
    torch.cuda.synchronize()
    assert kb.nms_grouped_kernel.launches == before + 1
    want = kb.nms_unsorted_fixpoint(*arrs[:3], thresh, groups=arrs[3])
    assert torch.equal(got, want)
    if case == "at_thresh":
        assert got.tolist() == [[True, True, False]] * 3
    if case == "chain":  # every other step of the staircase survives
        assert int(got.sum()) == 3 * 48


@pytest.mark.parametrize("case", BATCHED_EDGES)
@pytest.mark.parametrize("B", [3, 5])
def test_batched_nms_kernel_edge_cases(cuda, case, B):
    """Kernel C (a warp a problem, four a block): the same edge cases up to
    128 slots, at batches that fill the last block or not."""
    boxes, scores, valid, _, thresh = _nms_edge_problem(case)
    reps = -(-B // boxes.shape[0])
    arrs = [torch.from_numpy(np.concatenate([a] * reps)[:B]).to(cuda) for a in (boxes, scores, valid)]
    before = kc.nms_batched_kernel.launches
    got = kc.nms_batched_kernel(*arrs, thresh)
    torch.cuda.synchronize()
    assert kc.nms_batched_kernel.launches == before + 1
    assert torch.equal(got, kb.nms_unsorted_fixpoint(*arrs, thresh))


SORTED_EDGES = ["N1", "N31", "N33", "N511", "N513", "N1024", "N2048", "Nmax", "all_invalid",
                "one_cluster", "chain", "at_thresh", "thresh0", "thresh-0.1", "special_scores"]


@pytest.mark.parametrize("case", SORTED_EDGES)
def test_sorted_nms_kernel_edge_cases(cuda, case):
    """Kernel D's keep sets equal the plain version's: sizes around a warp,
    around the old 512-slot limit and up to the limit, nothing valid, one
    cluster, a chain across chunks, an IoU exactly at the threshold,
    thresholds 0 and below, and the visit key's traps (ties, ±0.0, NaN,
    ±inf)."""
    boxes, scores, valid, _, thresh = _nms_edge_problem(case)
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (boxes, scores, valid)]
    before = kd.nms_sorted_kernel.launches
    got = kd.nms_sorted_kernel(*arrs, thresh)
    torch.cuda.synchronize()
    assert kd.nms_sorted_kernel.launches == before + 1
    assert torch.equal(got, kd.nms_sorted_greedy(*arrs, thresh))
    if case == "at_thresh":
        assert got.tolist() == [[True, True, False]] * 3
    if case == "chain":
        assert int(got.sum()) == 3 * 48
    if case == "one_cluster":
        assert 3 <= int(got.sum()) < 3 * 32


def test_sorted_nms_kernel_on_the_frame_nms_tools_problems(cuda):
    """The frame-NMS tool's own problems (8 frames × 30 classes of 512 slots,
    ~17 valid a problem): the warp path and the block path both run."""
    from chip_smoke import frame_nms_protos
    from vdetlib_tpu_torch.video.frame_nms import pack_frame_problems

    boxes, scores, valid, _, _ = pack_frame_problems(*frame_nms_protos(8, 512, seed=512), 512)
    T, C, N = scores.shape
    b = torch.from_numpy(np.repeat(boxes[:, None], C, 1).reshape(T * C, N, 4)).to(cuda)
    s = torch.from_numpy(scores.reshape(T * C, N)).to(cuda)
    v = torch.from_numpy(valid.reshape(T * C, N)).to(cuda)
    n_valid = v.sum(1)
    assert int(n_valid.max()) > 32 and 0 < int((n_valid <= 32).sum()) < T * C
    got = kd.nms_sorted_kernel(b, s, v, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, kd.nms_sorted_greedy(b, s, v, 0.3))
    assert 0 < int(got.sum()) < int(v.sum())


def test_sorted_nms_kernel_is_one_launch_a_call(cuda):
    """No torch sort, gather or scatter around D: the profiler sees one
    device kernel a call, D's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in nms_problem(64, 512, seed=5))
    kd.nms_sorted_kernel(boxes, scores, valid, 0.3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kd.nms_sorted_kernel(boxes, scores, valid, 0.3)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "nms_sorted_kernel" in names[0], names


def test_batched_nms_routes_1024_slots_to_the_sorted_kernel(cuda):
    """Above B's 512 slots ``batched_nms`` launches D once (it raised before)."""
    from vdetlib_tpu_torch.kernels.nms import batched_nms

    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in nms_problem(6, 1024, seed=4))
    before_b, before_d = kb.nms_grouped_kernel.launches, kd.nms_sorted_kernel.launches
    got = batched_nms(boxes, scores, valid, 0.3)
    torch.cuda.synchronize()
    assert kd.nms_sorted_kernel.launches == before_d + 1
    assert kb.nms_grouped_kernel.launches == before_b
    assert torch.equal(got, kb.nms_unsorted_fixpoint(boxes, scores, valid, 0.3))
    assert 0 < int(got.sum()) < int(valid.sum())


def test_batched_nms_routes_192_slots_to_the_grouped_kernel(cuda):
    """The stream's MGP dedup shape for one class, 32 frames of 192 slots:
    ``batched_nms`` launches B once with one group, and not C."""
    from vdetlib_tpu_torch.kernels.nms import batched_nms

    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in nms_problem(32, 192, seed=9))
    before_b, before_c = kb.nms_grouped_kernel.launches, kc.nms_batched_kernel.launches
    got = batched_nms(boxes, scores, valid, 0.3)
    torch.cuda.synchronize()
    assert kb.nms_grouped_kernel.launches == before_b + 1
    assert kc.nms_batched_kernel.launches == before_c
    assert torch.equal(got, kb.nms_unsorted_fixpoint(boxes, scores, valid, 0.3))
    assert 0 < int(got.sum()) < int(valid.sum())


def test_nms_grouped_routes_576_slots_to_the_fixpoint(cuda):
    """The fused dedup at ``mgp_window`` 4 (64 × 9 = 576 slots, 30 class
    groups): above B's 512 slots ``nms_grouped`` runs the sort-free fixpoint
    in torch ops (it raised before), launches no B, and equals the CPU's
    plain version."""
    from vdetlib_tpu_torch.kernels.nms import nms_grouped

    arrs = [torch.from_numpy(a) for a in nms_problem(64, 576, seed=12, groups=30)]
    before = kb.nms_grouped_kernel.launches
    got = nms_grouped(*(a.to(cuda) for a in arrs), 0.3)
    torch.cuda.synchronize()
    assert kb.nms_grouped_kernel.launches == before
    want = kb.nms_unsorted_fixpoint(*arrs[:3], 0.3, groups=arrs[3])
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < int(arrs[2].sum())


def test_batched_nms_above_the_sorted_kernels_limit(cuda):
    """Above D's 8,192 slots ``batched_nms`` runs the sort-free fixpoint in
    torch ops (it raised before), launches no D, and equals the CPU's plain
    version."""
    from vdetlib_tpu_torch.kernels.nms import batched_nms

    arrs = [torch.from_numpy(a) for a in nms_problem(2, 8200, seed=13)]
    before = kd.nms_sorted_kernel.launches
    got = batched_nms(*(a.to(cuda) for a in arrs), 0.3)
    torch.cuda.synchronize()
    assert kd.nms_sorted_kernel.launches == before
    want = kb.nms_unsorted_fixpoint(*arrs, 0.3)
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < int(arrs[2].sum())


def test_flow_video_of_one_frame_launches_nothing(cuda):
    """A one-frame video has no pair: ``flow_video`` returns the empty field
    on the card without a launch of A (whose wrapper refuses zero pairs)."""
    frames = torch.from_numpy(_flow_video().frames[:1]).to(cuda)
    before = kl.flow_level.launches
    for upsample, hw in ((False, (60, 80)), (True, (240, 320))):
        got = tflow.flow_video(frames, preset="fastest", upsample=upsample)
        assert got.shape == (0, *hw, 2) and got.device == frames.device
    assert kl.flow_level.launches == before


def test_flow_kernel_at_the_mgp_shape(cuda):
    """The staged MGP's shape: 95 pairs of 90×120 (96 native 360×480
    frames at quarter resolution), box shifts of the objects' boxes within
    the MGP tolerance of its plain version."""
    sv = make_video(SynthConfig(num_frames=96, height=360, width=480, num_objects=8,
                                num_classes=4, seed=20))
    gray = tflow.to_gray(torch.from_numpy(sv.frames).to(cuda))
    gray = tflow._avg_pool2(tflow._avg_pool2(gray)).to(torch.bfloat16)
    i1, i2 = gray[:-1].contiguous(), gray[1:].contiguous()
    before = kl.flow_level.launches
    got = kl.flow_level(i1, i2)
    torch.cuda.synchronize()
    assert kl.flow_level.launches == before + 1
    want = kl._flow_level(i1, i2)
    assert got.shape == want.shape == (95, 90, 120, 2)
    boxes = torch.from_numpy(sv.gt_boxes[:, :95].transpose(1, 0, 2).copy()).to(cuda) / 4
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    d = (tflow.mean_flow_in_boxes(got, boxes, valid)
         - tflow.mean_flow_in_boxes(want, boxes, valid)).abs() * 4  # full-res px
    assert float(d.mean()) < 0.05 and float(d.max()) < 0.5, (float(d.mean()), float(d.max()))
    assert float(want.abs().max()) > 0.5


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


def _pyramid_levels(frames_u8, dev, levels=3):
    """The "accurate" preset's float32 gray levels: full, half, quarter."""
    g = [tflow.to_gray(torch.from_numpy(frames_u8).to(dev))]
    for _ in range(levels - 1):
        g.append(tflow._avg_pool2(g[-1]))
    return g


@pytest.mark.parametrize("search, radius", [(3, 3), (5, 3), (2, 1)])
@pytest.mark.parametrize("P, level", [(63, 0), (63, 1), (63, 2), (255, 2), (3, 0)])
def test_flow_kernel_float32_levels_match_plain_version(cuda, P, level, search, radius):
    """Kernel A's float32 path at the "accurate" pyramid's level shapes for
    240×320 frames (240×320, 120×160, 60×80) of a 64-frame video, at 255
    pairs, and a 3-pair video; (3, 3) is the pyramid's compiled-in window,
    (5, 3) the fast presets', (2, 1) the run-time kernel: the box-shift
    tolerance on the level's grid, in full-resolution pixels."""
    sv = _flow_video()
    gray = _pyramid_levels(sv.frames[:P + 1], cuda)[level]
    i1, i2 = gray[:-1].contiguous(), gray[1:].contiguous()
    assert i1.dtype == torch.float32
    before = kl.flow_level.launches
    got = kl.flow_level(i1, i2, search=search, radius=radius)
    torch.cuda.synchronize()
    assert kl.flow_level.launches == before + 1
    want = kl._flow_level(i1, i2, search, radius)
    assert got.shape == want.shape == (P, 240 >> level, 320 >> level, 2)
    pool = 2 ** level
    boxes = torch.from_numpy(sv.gt_boxes[:, :P].transpose(1, 0, 2).copy()).to(cuda) / pool
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    d = (tflow.mean_flow_in_boxes(got, boxes, valid)
         - tflow.mean_flow_in_boxes(want, boxes, valid)).abs() * pool
    assert float(d.mean()) < 0.05 and float(d.max()) < 0.5, (float(d.mean()), float(d.max()))
    assert float(want.abs().max()) > 0.5


def test_flow_video_accurate_launches_a_level_and_matches_the_cpu(cuda):
    """On the card the pyramid runs every level through kernel A (one launch
    a level, never the plain version) and agrees with the CPU's pyramid
    (the plain level) by box shifts at full resolution."""
    sv = _flow_video()
    frames = sv.frames[:9]
    before = kl.flow_level.launches
    got = tflow.flow_video(torch.from_numpy(frames).to(cuda), preset="accurate")
    torch.cuda.synchronize()
    assert kl.flow_level.launches == before + 3
    want = tflow.flow_video(torch.from_numpy(frames), preset="accurate")
    assert got.shape == want.shape == (8, 240, 320, 2)
    boxes = torch.from_numpy(sv.gt_boxes[:, :8].transpose(1, 0, 2).copy())
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    d = (tflow.mean_flow_in_boxes(got.cpu(), boxes, valid)
         - tflow.mean_flow_in_boxes(want, boxes, valid)).abs()
    assert float(d.mean()) < 0.05 and float(d.max()) < 0.5, (float(d.mean()), float(d.max()))
    one = tflow.flow_video(torch.from_numpy(frames[:1]).to(cuda), preset="accurate")
    assert one.shape == (0, 240, 320, 2) and kl.flow_level.launches == before + 3


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
        kl.flow_level(a.double(), a.double())  # bf16 or float32 only
    with pytest.raises(TypeError):
        kl.flow_level(a, a.to(torch.bfloat16))  # one type for both
    with pytest.raises(ValueError):
        kl.flow_level(a.to(torch.bfloat16), a.cpu().to(torch.bfloat16))
    b = torch.zeros((1, 600, 4), device=cuda)
    s = torch.zeros((1, 600), device=cuda)
    with pytest.raises(ValueError):
        kb.nms_grouped_kernel(b, s, s.bool(), s.int(), 0.5)  # N > 512
    n = kd.MAX_SLOTS + 1  # D's limit, from its shared memory (8192)
    with pytest.raises(ValueError, match=f"N <= {kd.MAX_SLOTS}"):
        kd.nms_sorted_kernel(torch.zeros((1, n, 4), device=cuda), torch.zeros((1, n), device=cuda),
                             torch.zeros((1, n), dtype=torch.bool, device=cuda), 0.5)
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


def _resize_edge_frames(case, dev):
    """(frames on ``dev``, out_hw, pixel_mean, pixel_scale) of one edge case."""
    rng = np.random.default_rng(len(case))
    mean, scale = ke.PIXEL_MEAN, 1.0

    def video(B, H, W):
        return torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)

    if case == "1x1":
        return video(1, 1, 1), (1, 1), mean, scale
    if case == "down_odd":
        return video(3, 7, 13), (5, 9), mean, scale
    if case == "up_odd":
        return video(3, 5, 9), (7, 13), mean, scale
    if case == "odd_offset":  # frames of 273 bytes: the batch starts at byte 273
        return video(4, 7, 13)[1:], (5, 9), mean, scale
    if case == "B1":
        return video(1, 360, 480), (240, 320), mean, scale
    if case == "B13":
        return video(13, 240, 320), (304, 400), mean, scale
    assert case == "mean_scale"
    return video(2, 36, 52), (24, 34), (1.5, -20.25, 250.0), 0.017


@pytest.mark.parametrize("case", ["1x1", "down_odd", "up_odd", "odd_offset", "B1", "B13",
                                  "mean_scale"])
def test_resize_kernel_edge_cases(cuda, case):
    """Sizes of 1 and odd sizes (rows of 3, 21 and 27 bytes, output rows that
    are not 16-byte aligned), a batch at an odd byte offset, one frame and
    13, another mean and scale: abs <= 1e-3, one launch each."""
    frames, hw, mean, scale = _resize_edge_frames(case, cuda)
    before = ke.fused_resize_normalize_kernel.launches
    got = ke.fused_resize_normalize_kernel(frames, hw, mean, scale)
    torch.cuda.synchronize()
    assert ke.fused_resize_normalize_kernel.launches == before + 1
    want = ke.fused_resize_normalize(frames, hw, mean, scale)
    assert got.shape == want.shape == (frames.shape[0],) + hw + (3,)
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


def _scan_both(cfg, feats, ats, boxes, dev, conf_thresh=0.5):
    from vdetlib_tpu_torch.nn.tracker_net import extract_template

    ats = torch.as_tensor(ats, device=dev)
    boxes = torch.as_tensor(boxes, device=dev)
    args = (feats, ats, boxes, extract_template(feats[ats], boxes, cfg), cfg, conf_thresh)
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


def _rollout_within_bounds(got, want):
    for gb, gc, ga, wb, wc, wa in ((*got[:3], *want[:3]), (*got[3:], *want[3:])):
        assert torch.equal(ga, wa)
        if wa.any():
            assert float((gb - wb).abs()[wa].max()) < 0.1
            assert float((gc - wc).abs()[wa].max()) < 5e-3


@pytest.mark.parametrize("case", ["A1", "A3", "anchors_0_and_last", "edges", "dies", "T1",
                                  "C36_scalar", "C100", "f32_Q20", "f32_Q23_one_partial",
                                  "A17", "A34", "f32_C38_scalar"])
def test_scan_kernel_edge_cases(cuda, scan_inputs, case):
    """What the redesigned kernel adds or risks, against the plain version
    (alive equal, live boxes < 0.1 px, live conf < 5e-3; T = 1 exactly): one
    anchor and an odd count (clusters of one lane pair, idle warps); anchors
    at the first and the last frame; boxes that touch or cross the frame's
    edge (clamped taps); lanes that die
    mid-scan (conf_thresh 0.8); one frame; C = 36 and 100 (no 16-byte
    channel vectors: the scalar pooling and the run-time correlation);
    float32 features at Q = 20 and Q = 23 (one partial response) and at
    C = 38 (the float32 scalar pooling); A = 17 and 34 (clusters of 2 and of
    1 block a lane on the H100's 132 SMs: other row splits and correlation
    spreads)."""
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig

    cfg, sv, feats = scan_inputs
    T, h, w, _ = feats.shape
    H, W = 4 * h, 4 * w
    ats = np.array([0, 3, 7, 12, 15, 9, 5, 1])
    boxes = sv.gt_boxes[np.arange(8) % sv.gt_boxes.shape[0], 2 * ats].astype(np.float32)
    thresh = 0.5
    if case == "A1":
        ats, boxes = ats[:1], boxes[:1]
    elif case == "A3":
        ats, boxes = ats[:3], boxes[:3]
    elif case == "anchors_0_and_last":
        ats = np.array([0, T - 1, 0, T - 1])
        boxes = sv.gt_boxes[np.arange(4) % sv.gt_boxes.shape[0], 2 * ats].astype(np.float32)
    elif case == "edges":
        boxes = np.array([[0.0, 0.0, 60.0, 50.0], [-20.0, -15.0, 30.0, 25.0],
                          [W - 60.0, H - 50.0, W, H], [W - 30.0, H - 25.0, W + 20.0, H + 15.0],
                          [-10.0, H / 2, 40.0, H / 2 + 50.0], [W / 2, -30.0, W / 2 + 60.0, 20.0],
                          [0.0, 0.0, W, H], [W - 1.0, H - 1.0, W + 40.0, H + 40.0]], np.float32)
    elif case == "dies":
        thresh = 0.8
    elif case == "T1":
        feats, ats, boxes = feats[:1], ats[:3] * 0, boxes[:3]
    elif case == "C36_scalar":
        feats = feats[..., :36].contiguous()
    elif case == "C100":
        feats = torch.cat([feats, feats[..., :4]], -1)
    elif case == "f32_Q20":
        feats, cfg = feats.float(), TrackerConfig(search_factor=2.5)
    elif case == "f32_Q23_one_partial":
        feats, cfg = feats.float(), TrackerConfig(search_factor=2.875)
    elif case == "f32_C38_scalar":
        feats = feats[..., :38].float().contiguous()
    elif case in ("A17", "A34"):
        rng = np.random.default_rng(int(case[1:]))
        ats = rng.integers(0, T, int(case[1:]))
        k = rng.integers(0, sv.gt_boxes.shape[0], ats.shape[0])
        boxes = (sv.gt_boxes[k, 2 * ats] + rng.normal(0, 3, (ats.shape[0], 4))).astype(np.float32)
    # the cluster size each case covers (A <= 8: 4 blocks a lane)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kf.cluster_ctas(ats.shape[0], sms) == {"A17": 2, "A34": 1}.get(case, 4)
    if case == "f32_Q23_one_partial":
        assert kf.launch_parts(cfg.search_pool, 8, 96, False) == 1
    got, want = _scan_both(cfg, feats, ats, boxes.astype(np.float32), cuda, thresh)
    _rollout_within_bounds(got, want)
    if case == "T1":
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
    if case == "dies":  # a lane tracks past its anchor, then dies before the scan ends
        fa, ba = want[2], want[5]
        assert any(int(fa[:, k].sum()) > 1 and not fa[-1, k] for k in range(fa.shape[1])) or \
            any(int(ba[:, k].sum()) > 1 and not ba[0, k] for k in range(ba.shape[1]))


def _track_batch_both(cfg, feats, dev, snap=None):
    """``track_batch`` on the card and on the CPU (16 steps, 8 anchors);
    returns (card, cpu, F launches on the card)."""
    from vdetlib_tpu_torch.video.track import track_batch

    ats = torch.tensor([0, 3, 7, 12, 15, 9, 5, 1])
    boxes = torch.from_numpy(scan_inputs_boxes(ats.numpy()))
    before = kf.track_scan_kernel.launches
    with torch.no_grad():
        got = track_batch(cfg, feats, ats.to(dev), boxes.to(dev), 0.5,
                          snap=None if snap is None else tuple(a.to(dev) for a in snap))
        torch.cuda.synchronize()
        launches = kf.track_scan_kernel.launches - before
        want = track_batch(cfg, feats.cpu(), ats, boxes, 0.5, snap=snap)
    return [g.cpu() for g in got], want, launches


def scan_inputs_boxes(ats):
    sv = make_video(SynthConfig(num_frames=32, height=360, width=480, num_objects=6, seed=4))
    return sv.gt_boxes[np.arange(len(ats)) % sv.gt_boxes.shape[0], 2 * ats].astype(np.float32)


@pytest.mark.parametrize("option", ["snap", "eta", "scales3", "none"])
def test_track_batch_takes_kernel_f_only_in_its_contract(cuda, scan_inputs, option):
    """Snapping, EMA templates and three scales run the plain scan on the
    card (no launch of F, as the JAX package runs its XLA scan for them)
    and agree with the CPU's run: alive equal, live boxes < 0.5 px, live
    conf < 5e-3 over 16 steps (the cross-device rounding of the convolutions
    and pooling, amplified by the rollout); a snap-free, eta-0 call
    launches F once."""
    import dataclasses

    cfg, sv, feats = scan_inputs
    snap = None
    if option == "snap":
        rng = np.random.default_rng(5)
        db = sv.gt_boxes[:, ::2].transpose(1, 0, 2) + rng.normal(0, 3, (16, 6, 4))
        snap = (torch.from_numpy(db.astype(np.float32)),
                torch.from_numpy(rng.uniform(0.3, 1, (16, 6)).astype(np.float32)),
                torch.ones((16, 6), dtype=torch.bool))
    elif option == "eta":
        cfg = dataclasses.replace(cfg, template_eta=0.1, template_update_conf=0.3)
    elif option == "scales3":
        cfg = dataclasses.replace(cfg, num_scales=3)
    got, want, launches = _track_batch_both(cfg, feats, cuda, snap)
    assert launches == (1 if option == "none" else 0)
    gb, gc, ga = got
    wb, wc, wa = want
    assert torch.equal(ga, wa) and bool(wa.any())
    assert float((gb - wb).abs()[wa].max()) < 0.5
    assert float((gc - wc).abs()[wa].max()) < 5e-3


def test_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda, scan_inputs):
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig

    cfg, sv, feats = scan_inputs
    ats = torch.zeros(1, dtype=torch.int64, device=cuda)
    box = torch.tensor([[10.0, 10.0, 60.0, 60.0]], device=cuda)
    tpl = torch.zeros((1, 8, 8, 96), device=cuda)
    with pytest.raises(ValueError):
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(num_scales=3), 0.5)
    with pytest.raises(ValueError):
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(template_eta=0.1), 0.5)
    with pytest.raises(TypeError):
        kf.track_scan_kernel(feats.half(), ats, box, tpl, cfg, 0.5)
    with pytest.raises(ValueError):
        kf.track_scan_kernel(feats, ats, box, tpl[:, :4], cfg, 0.5)
    with pytest.raises(ValueError):  # Q = 4 < P = 8
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(search_factor=0.5), 0.5)
    with pytest.raises(ValueError, match="shared memory"):  # 33x33x96 bf16, even with one partial
        kf.track_scan_kernel(feats, ats, box, tpl, TrackerConfig(search_factor=4.125), 0.5)
    with pytest.raises(ValueError, match="shared memory"):  # 24x24x96 float32
        kf.track_scan_kernel(feats.float(), ats, box, tpl, TrackerConfig(search_factor=3.0), 0.5)


# kernel G's cases: (C, T, N, max_paths, rescore, offset, ties, a lane masked)
SEQ_NMS_CASES = {
    "sweep_288": (30, 288, 64, 100, "avg", 1.0, False, False),
    "sweep_480": (30, 480, 64, 100, "max", 1.0, True, False),
    "N1": (3, 40, 1, 100, "avg", 1.0, False, True),
    "N17_ties_offset0": (3, 40, 17, 100, "avg", 0.0, True, True),
    "N63_max": (3, 40, 63, 100, "max", 0.0, True, True),
    "N64_budget": (4, 40, 64, 5, "avg", 1.0, True, True),
    "N64_max_budget": (4, 40, 64, 7, "max", 0.0, False, False),
    "T1": (3, 1, 64, 100, "avg", 1.0, True, True),
    "T1_budget": (2, 1, 33, 4, "max", 1.0, False, False),
    "T3200": (2, 3200, 64, 3, "avg", 1.0, True, True),
}


@pytest.mark.parametrize("case", SEQ_NMS_CASES)
def test_seq_nms_kernel_equals_plain_version(cuda, case):
    C, T, N, paths, rescore, offset, ties, masked = SEQ_NMS_CASES[case]
    boxes, scores, mask = seq_nms_problem(C, T, N, seed=T + N, ties=ties)
    if masked:
        mask[1] = False
    args = [torch.from_numpy(a).to(cuda) for a in (boxes, scores, mask)]
    before = kg.seq_nms_kernel.launches
    got = kg.seq_nms_batch(*args, 0.5, 0.3, max_paths=paths, rescore=rescore, offset=offset)
    torch.cuda.synchronize()
    assert kg.seq_nms_kernel.launches == before + 1
    want = kg.seq_nms_plain(*args, 0.5, 0.3, max_paths=paths, rescore=rescore, offset=offset)
    n_paths = seq_nms_equal(got, want, rescore)
    found = want[1].amax((1, 2)) + 1
    assert n_paths >= C - masked and int(found.max()) <= paths
    if masked:
        assert int(found[1]) == 0 and bool((got[1][1] == -1).all())
    if "budget" in case:
        assert int(found.max()) == paths  # the budget ends some lane's paths
    if N > 1 and T > 1:
        assert bool((got[0] == -1).any()), "nothing suppressed"


def _oracle_seq_nms():
    """``tests/oracle/seq_nms.py::seq_nms``, imported from this checkout's
    tests/ directory even where an installed ``tests`` package would shadow
    it (as on the card's machine, where the file runs without conftest)."""
    import sys
    import types
    from pathlib import Path

    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "tests" or k.startswith("tests.")}
    pkg = types.ModuleType("tests")
    pkg.__path__ = [str(Path(__file__).resolve().parent)]
    sys.modules["tests"] = pkg
    try:
        from tests.oracle.seq_nms import seq_nms
    finally:
        for k in [k for k in sys.modules if k == "tests" or k.startswith("tests.")]:
            del sys.modules[k]
        sys.modules.update(saved)
    return seq_nms


def test_seq_nms_kernel_matches_oracle(cuda):
    oracle_seq_nms = _oracle_seq_nms()
    boxes, scores, mask = seq_nms_problem(2, 12, 17, seed=3, ties=True)
    out, pid = (x.cpu().numpy() for x in kg.seq_nms_kernel(
        *(torch.from_numpy(a).to(cuda) for a in (boxes, scores, mask)), 0.5, 0.3, max_paths=50))
    for c in range(2):
        s, m = scores[c], mask[c]
        want, paths = oracle_seq_nms([boxes[t][m[t]] for t in range(12)],
                                     [s[t][m[t]] for t in range(12)], 0.5, 0.3, max_paths=50)
        for t in range(12):
            np.testing.assert_allclose(out[c, t][m[t]], want[t], atol=1e-5, rtol=0)
        assert int(pid[c].max()) + 1 == len(paths) > 2
        for k, (_, path) in enumerate(paths):
            on = {(t, int(np.nonzero(m[t])[0][i])) for t, i in path}
            assert on == {tuple(x) for x in np.argwhere(pid[c] == k)}


def test_seq_nms_kernel_is_one_launch_a_call(cuda):
    """The profiler sees one G kernel a call; the rest of the call's device
    work is ``link_masks``'s torch ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = [torch.from_numpy(a).to(cuda) for a in seq_nms_problem(30, 64, 64, seed=2)]
    kg.seq_nms_kernel(*args, 0.5, 0.3)
    torch.cuda.synchronize()
    before = kg.seq_nms_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kg.seq_nms_kernel(*args, 0.5, 0.3)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("seq_nms_kernel" in n for n in names) == 1, names
    assert kg.seq_nms_kernel.launches == before + 1


def test_seq_nms_routes_900_slots_to_the_plain_version(cuda):
    """The stream's video-end linking, 30 lanes of 282 frames × 900 slots:
    no G launch, ``plain_calls`` counts the call, equal to the CPU's."""
    arrs = [torch.from_numpy(a) for a in seq_nms_problem(30, 282, 900, seed=21)]
    before, plain = kg.seq_nms_kernel.launches, kg.seq_nms_batch.plain_calls
    got = kg.seq_nms_batch(*(a.to(cuda) for a in arrs), 0.5, 0.3, max_paths=2)
    torch.cuda.synchronize()
    assert kg.seq_nms_kernel.launches == before
    assert kg.seq_nms_batch.plain_calls == plain + 1
    assert seq_nms_equal(got, kg.seq_nms_plain(*arrs, 0.5, 0.3, max_paths=2), "avg") == 60


def test_seq_nms_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    boxes, scores, mask = (torch.from_numpy(a).to(cuda) for a in seq_nms_problem(3, 8, 16, seed=1))
    with pytest.raises(TypeError):
        kg.seq_nms_kernel(boxes, scores.double(), mask, 0.5, 0.3)
    with pytest.raises(TypeError):
        kg.seq_nms_kernel(boxes.double(), scores, mask, 0.5, 0.3)
    with pytest.raises(ValueError, match="contiguous"):
        kg.seq_nms_kernel(boxes, scores.transpose(1, 2).contiguous().transpose(1, 2), mask, 0.5,
                          0.3)
    with pytest.raises(ValueError):
        kg.seq_nms_kernel(boxes.cpu(), scores, mask, 0.5, 0.3)
    wide = [torch.from_numpy(a).to(cuda) for a in seq_nms_problem(1, 4, 65, seed=1)]
    with pytest.raises(ValueError, match="N <= 64"):
        kg.seq_nms_kernel(*wide, 0.5, 0.3)
