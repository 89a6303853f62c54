"""vdetlib_tpu_torch — the PyTorch/CUDA port of :mod:`vdetlib_tpu`.

The same T-CNN video-detection stages as the JAX package, written for one
NVIDIA Hopper GPU: plain tensor code is PyTorch, and each Pallas kernel on a
ported path is a hand-written CUDA C++ kernel (``csrc/``) with a plain
PyTorch version beside it in the same module. The subpackages mirror the JAX
package so every function has an obvious counterpart:

- :mod:`.geometry` — box math with the legacy +1 pixel convention;
- :mod:`.nn` — detector (backbone, ROI-align head) and tracker networks;
- :mod:`.kernels` — flow, NMS and seq-NMS, with the CUDA kernel wrappers;
- :mod:`.video` — the staged stages (detection, MGP, tracking, tubelet
  perturbation, rescoring, seq-NMS linking), the streaming engine and
  per-frame NMS over protos;
- :mod:`.pipeline` — the fused single-program pipeline;
- :mod:`.cli` — the stage tools (``python -m vdetlib_tpu_torch <tool>``);
- :mod:`.protos`, :mod:`.data`, :mod:`.utils` — JSON protos, synthetic
  videos and frame loading, logging, JAX's key stream in numpy;
- :mod:`.weights` — Flax parameter trees → torch modules, and seeded init.

Public functions keep the JAX package's layouts: frames ``(T, H, W, 3)``
uint8 BGR, boxes ``[x1, y1, x2, y2]`` pixel space, features channels-last.
The package imports neither JAX nor anything of :mod:`vdetlib_tpu`: the host
modules it needs from there (protos, synthetic data, loader, logging) are
copied into it.
"""

__version__ = "0.1.0"
