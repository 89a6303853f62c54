"""vdetlib_tpu_torch — the PyTorch/CUDA port of :mod:`vdetlib_tpu`.

The same T-CNN video-detection stages as the JAX package, written for one
NVIDIA Hopper GPU: plain tensor code is PyTorch, and each Pallas kernel on a
ported path is a hand-written CUDA C++ kernel (``csrc/``) with a plain
PyTorch version beside it in the same module. The subpackages mirror the JAX
package so every function has an obvious counterpart:

- :mod:`.geometry` — box math with the legacy +1 pixel convention;
- :mod:`.nn` — detector (backbone, ROI-align head) and tracker networks;
- :mod:`.kernels` — flow, NMS and seq-NMS, with the CUDA kernel wrappers;
- :mod:`.video` — detection step, MGP hop, tracker scan, rescoring, linking;
- :mod:`.pipeline` — the fused single-program pipeline;
- :mod:`.weights` — Flax parameter trees → torch modules, and seeded init.

Public functions keep the JAX package's layouts: frames ``(T, H, W, 3)``
uint8 BGR, boxes ``[x1, y1, x2, y2]`` pixel space, features channels-last.
The package imports no JAX; of :mod:`vdetlib_tpu` it reuses only host
modules that import without JAX (``protos``, ``data.synth``).
"""

__version__ = "0.1.0"
