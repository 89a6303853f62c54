"""Networks: detector (backbone + ROI head) and correlation tracker."""

from vdetlib_tpu_torch.nn.backbone import Backbone, BackboneConfig  # noqa: F401
from vdetlib_tpu_torch.nn.detector import Detector, DetectorConfig  # noqa: F401
from vdetlib_tpu_torch.nn.heads import RCNNHead, roi_align  # noqa: F401
