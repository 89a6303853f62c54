"""The trainers on a card: the held-out eval launches kernel C, and one tiny
float32 training step on the card equals the CPU's.

- ``evaluate_heldout_map`` (the train_detector tool's eval) with the tiny
  detector at 96×128 and 64 proposals a frame runs its per-class NMS on
  kernel C, once a video, and C's keep sets equal its plain version on the
  eval's own (frames × classes, 64) problems;
- one step of the tiny float32 detector and of the float32 tracker's
  "pair" and "aware" recipes (``chip_smoke.tiny_train_cases``): the loss
  within 1e-5 relative, every gradient within 1e-4 (detector) or 1e-3
  (tracker, see tests/test_torch_tracker_train.py) of its tensor's largest
  magnitude, and the optimizer on the card given the CPU's gradients within
  1e-6.

Every test carries the ``cuda`` marker and skips without a card (decided in
a fixture, so every worker collects the same tests).
"""

import numpy as np
import pytest
import torch

from chip_smoke import tiny_train_cases
from vdetlib_tpu_torch.data.synth import SynthConfig, make_video
from vdetlib_tpu_torch.kernels import nms_batched as kc
from vdetlib_tpu_torch.kernels import nms_grouped as kb
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.weights import init_detector

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trainers' kernels and steps run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_heldout_eval_launches_kernel_c(cuda):
    from vdetlib_tpu_torch.cli.train_detector import evaluate_heldout_map, heldout_problems

    C = 4
    det = init_detector(detector_preset("tiny", num_classes=C), device=cuda)
    videos = [make_video(SynthConfig(num_frames=8, height=96, width=128, num_classes=C,
                                     seed=10_000 + i)) for i in range(2)]
    before = kc.nms_batched_kernel.launches
    m, _ = evaluate_heldout_map(det, videos, C, 64)
    torch.cuda.synchronize()
    assert kc.nms_batched_kernel.launches == before + len(videos)
    assert 0.0 <= m <= 1.0
    for sv in videos:
        boxes, scores, valid = heldout_problems(det, sv, 64)
        assert boxes.shape == (8, C, 64, 4)
        args = (boxes.reshape(-1, 64, 4).contiguous(), scores.reshape(-1, 64).contiguous(),
                valid.reshape(-1, 64).contiguous())
        got = kc.nms_batched_kernel(*args, 0.3)
        assert torch.equal(got, kb.nms_unsorted_fixpoint(*args, 0.3))
        assert 0 < int(got.sum()) < int(args[2].sum())


def test_tiny_training_step_card_equals_cpu(cuda):
    cases = tiny_train_cases(cuda)
    assert set(cases) == {"detector", "tracker pair", "tracker aware"}
    for loss_rel, grad_rel, param_err in cases.values():
        assert np.isfinite(loss_rel) and loss_rel <= 1e-5
        assert grad_rel <= 1e-3 and param_err <= 1e-6
