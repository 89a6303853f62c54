"""Shared float32 tiny nets of the fused parity tests (tests/test_torch_fused.py,
tests/test_torch_fused_runner.py).

The tiny preset's widths (stem 16, stages (1, 1, 1) × (32, 64, 128), head
128) for C = 4 classes at 96×128 with R = 16 proposals: the JAX detector in
float32, backbone and head (at bf16 the two frameworks round at different
places; see tests/test_torch_fused.py), its random box-regression layer
scaled by 0.1 to a trained regressor's delta scale (tests/test_torch_detector.py),
the default tracker in float32, and the same weights converted to the port.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vdetlib_tpu.nn import tracker_net as jtn
from vdetlib_tpu.nn.backbone import Backbone as JBackbone
from vdetlib_tpu.nn.backbone import BackboneConfig as JBackboneConfig
from vdetlib_tpu.nn.detector import Detector as JDetector
from vdetlib_tpu.nn.detector import DetectorConfig as JDetectorConfig
from vdetlib_tpu.nn.heads import RCNNHead as JRCNNHead
from vdetlib_tpu.video.track import init_tracker as j_init_tracker
from vdetlib_tpu_torch.nn.detector import Detector
from vdetlib_tpu_torch.nn.presets import detector_preset
from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig, TrackerNet
from vdetlib_tpu_torch.weights import detector_state_from_flax, tracker_state_from_flax

HW = (96, 128)
R, C = 16, 4


class F32Detector(JDetector):
    """The JAX detector with its head in float32 too (same parameter tree)."""

    def setup(self):
        self.backbone = JBackbone(self.config.backbone)
        self.head = JRCNNHead(num_classes=self.config.num_classes,
                              hidden=self.config.head_hidden, dtype=jnp.float32)


class Nets(NamedTuple):
    jdet: object  # F32Detector
    jdp: dict  # its params (numpy leaves)
    jtrk: object
    jtp: dict
    jtrk_cfg: object
    tdet: Detector  # the same weights in the port, on the CPU, eval mode
    ttrk: TrackerNet
    ttrk_cfg: TrackerConfig


def f32_nets() -> Nets:
    jdet_cfg = JDetectorConfig(
        num_classes=C, head_hidden=128,
        backbone=JBackboneConfig(stem_features=16, stage_sizes=(1, 1, 1),
                                 stage_features=(32, 64, 128), dtype=jnp.float32))
    jdet = F32Detector(jdet_cfg)
    jdp = jax.tree.map(np.asarray, jax.jit(jdet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)), jnp.zeros((1, R, 4))))
    # a trained regressor's delta scale (see tests/test_torch_detector.py)
    jdp["params"]["head"]["bbox"]["kernel"] = jdp["params"]["head"]["bbox"]["kernel"] * 0.1
    jtrk_cfg = jtn.TrackerConfig(dtype=jnp.float32)
    jtrk, jtp = j_init_tracker(jtrk_cfg, image_hw=HW, seed=0)
    tdet = Detector(detector_preset("tiny", num_classes=C, dtype=torch.float32))
    tdet.load_state_dict(detector_state_from_flax(jdp))
    tdet.head.dtype = tdet.head.fc0.dtype = torch.float32
    ttrk_cfg = TrackerConfig(dtype=torch.float32)
    ttrk = TrackerNet(ttrk_cfg)
    ttrk.load_state_dict(tracker_state_from_flax(jax.tree.map(np.asarray, jtp)))
    return Nets(jdet, jdp, jtrk, jtp, jtrk_cfg, tdet.eval(), ttrk.eval(), ttrk_cfg)
