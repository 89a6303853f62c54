"""Batched greedy NMS over many small problems: the CUDA kernel C.

Counterpart of ``vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_fixpoint``
(the TPU kernel, both variants) for problems of at most 128 slots. Its plain
version is :func:`~vdetlib_tpu_torch.kernels.nms_grouped.nms_unsorted_fixpoint`
(without groups), which computes the same function: the exact greedy keep
set, with the IoU op order, strict ``>`` and (score desc, index asc)
precedence of the JAX package and the numpy oracle.

:func:`nms_batched_kernel` is the wrapper: CPU tensors go through the plain
version, CUDA tensors through ``csrc/nms_batched.cu``.
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET
from vdetlib_tpu_torch.kernels import build
from vdetlib_tpu_torch.kernels.nms_grouped import (check_nms_inputs, launch_threads,
                                                   nms_unsorted_fixpoint)

MAX_SLOTS = 128  # a block a problem, as kernel B's; larger N take B


def nms_batched_kernel(boxes, scores, valid, thresh: float, offset: float = LEGACY_OFFSET):
    """Greedy NMS of (B, N) independent problems, N <= 128 → keep (B, N) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``nms_batched_kernel.launches`` counts the launches) or raise."""
    if all(t.device.type == "cpu" for t in (boxes, scores, valid)):
        return nms_unsorted_fixpoint(boxes, scores, valid, thresh, offset)
    B, N = check_nms_inputs("nms_batched", MAX_SLOTS, boxes, scores, valid)
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    fn = build.load("nms_batched")
    rc = fn(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, N,
        launch_threads(B, N, build.sm_count(boxes.device.index)), float(thresh), float(offset),
        torch.cuda.current_stream(boxes.device).cuda_stream,
    )
    build.check_launch("nms_batched", rc)
    nms_batched_kernel.launches += 1
    return keep


nms_batched_kernel.launches = 0
