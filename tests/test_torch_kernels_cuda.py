"""The hand-written CUDA kernels against their plain PyTorch versions, on a card.

At the shapes of the fused pipeline's main path (240×320 frames, the
"fastest" flow preset and the MGP dedup at the bench budget):

- kernel A (flow level), P=255 pairs of 60×80 bf16: the MGP box-shift
  tolerance of tests/test_mgp.py (mean < 0.05 px, max < 0.5 px). Both compute
  in float32; they differ only in summation order.
- kernel B (grouped NMS), 256 frames of 192 slots with 30 class groups, score
  ties, invalid and padded slots: keep sets identical.

Every test needs a CUDA device; without one it skips (the decision is made
in a fixture, so every worker collects the same tests). The wrappers' CPU
dispatch is covered by tests/test_torch_flow.py and tests/test_torch_nms.py.
"""

import numpy as np
import pytest
import torch

from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu_torch.kernels import flow as tflow
from vdetlib_tpu_torch.kernels import flow_level as kl
from vdetlib_tpu_torch.kernels import nms_grouped as kb


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _nms_problem(B=256, N=192, groups=30, pad=20, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 300, (B, N))
    y1 = rng.uniform(0, 220, (B, N))
    w = rng.uniform(8, 90, (B, N))
    h = rng.uniform(8, 90, (B, N))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]  # duplicates
    scores = (rng.integers(0, 20, (B, N)) / 20.0).astype(np.float32)  # ties
    grp = rng.integers(1, groups + 1, (B, N)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) > 0.15
    valid[:, N - pad:] = False
    grp[:, N - pad:] = -1
    return boxes, scores, valid, grp


def test_nms_kernel_equals_plain_version(cuda):
    arrs = [torch.from_numpy(a).to(cuda) for a in _nms_problem()]
    before = kb.nms_grouped_kernel.launches
    got = kb.nms_grouped_kernel(*arrs, 0.3)
    torch.cuda.synchronize()
    assert kb.nms_grouped_kernel.launches == before + 1
    want = kb.nms_unsorted_fixpoint(arrs[0], arrs[1], arrs[2], 0.3, groups=arrs[3])
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(arrs[2].sum())


def test_flow_kernel_matches_plain_version_box_shifts(cuda):
    sv = make_video(SynthConfig(num_frames=256, height=240, width=320, num_classes=4, seed=0))
    frames = torch.from_numpy(sv.frames).to(cuda)
    gray = tflow._avg_pool2(tflow._avg_pool2(tflow.to_gray(frames))).to(torch.bfloat16)
    i1, i2 = gray[:-1].contiguous(), gray[1:].contiguous()
    before = kl.flow_level.launches
    got = kl.flow_level(i1, i2)
    torch.cuda.synchronize()
    assert kl.flow_level.launches == before + 1
    want = kl._flow_level(i1, i2)
    assert got.shape == want.shape == (255, 60, 80, 2)
    boxes = torch.from_numpy(sv.gt_boxes[:, :255].transpose(1, 0, 2).copy()).to(cuda) * 0.25
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    d = (tflow.mean_flow_in_boxes(got, boxes, valid)
         - tflow.mean_flow_in_boxes(want, boxes, valid)).abs() * 4.0  # full-res px
    assert float(d.mean()) < 0.05 and float(d.max()) < 0.5, (float(d.mean()), float(d.max()))


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
