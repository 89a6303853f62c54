"""Flow, NMS and seq-NMS on tensors, with the wrappers of the hand-written CUDA kernels.

The names below are the JAX package's ``vdetlib_tpu.kernels`` exports.
Importing them builds and launches nothing: a kernel is compiled at its
first launch on a CUDA tensor (``kernels/build.py``).
"""

from vdetlib_tpu_torch.kernels.flow import flow_video, mean_flow_in_boxes  # noqa: F401
from vdetlib_tpu_torch.kernels.nms import (  # noqa: F401
    batched_nms,
    nms_fixpoint,
    nms_unsorted_fixpoint,
    nms_xla,
    sort_by_score,
)
from vdetlib_tpu_torch.kernels.preprocess import fused_resize_normalize  # noqa: F401
from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_batch, seq_nms_single  # noqa: F401
