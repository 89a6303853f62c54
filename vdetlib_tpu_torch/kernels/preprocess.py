"""Fused frame preprocessing: bilinear resize + BGR mean subtract, kernel E.

Counterpart of ``vdetlib_tpu/kernels/preprocess.py``. Frames cross to the
card as native-resolution uint8 and are resized to the network's input
there. :func:`fused_resize_normalize` is the plain version, the JAX
function's two separable float32 contractions with the interpolation
matrices of :func:`_resize_matrix`; :func:`fused_resize_normalize_kernel` is
the wrapper: CPU tensors go through the plain version, CUDA tensors through
``csrc/resize_normalize.cu``, which reads the at most two non-zero taps of
each matrix row (:func:`resize_taps`, taken from the same float32 matrix).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vdetlib_tpu_torch.kernels import build

PIXEL_MEAN = (102.98, 115.95, 122.77)  # BGR, the detector's default


def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix (align_corners=False)."""
    scale = src / dst
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    pos = np.clip(pos, 0.0, src - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    w_hi = pos - lo
    m = np.zeros((dst, src), dtype=np.float32)
    m[np.arange(dst), lo] += (1.0 - w_hi).astype(np.float32)
    m[np.arange(dst), hi] += w_hi.astype(np.float32)
    return m


def resize_taps(src: int, dst: int):
    """The two taps of each row of ``_resize_matrix(src, dst)``, read from the
    float32 matrix itself: its first and last non-zero column.

    Returns (lo, hi) int32 and (w_lo, w_hi) float32 arrays of length dst.
    Where a row has one non-zero entry (the clamped edge's summed entry, or
    a weight of exactly 0) ``hi == lo`` and ``w_hi`` is 0, so ``w_lo·x[lo] +
    w_hi·x[hi]`` is the row's dot product with every other term an exact 0."""
    m = _resize_matrix(src, dst)
    nz = m != 0
    rows = np.arange(dst)
    lo = nz.argmax(1)
    hi = src - 1 - nz[:, ::-1].argmax(1)
    assert (hi - lo <= 1).all(), "a bilinear row has taps more than one column apart"
    w_hi = np.where(hi != lo, m[rows, hi], np.float32(0.0)).astype(np.float32)
    return lo.astype(np.int32), hi.astype(np.int32), m[rows, lo], w_hi


@functools.lru_cache(maxsize=64)
def _device_taps(src: int, dst: int, device: torch.device):
    """:func:`resize_taps` on ``device``, copied there once per shape."""
    return tuple(torch.from_numpy(a).to(device) for a in resize_taps(src, dst))


def fused_resize_normalize(frames_u8, out_hw, pixel_mean=PIXEL_MEAN, pixel_scale: float = 1.0):
    """(B, H, W, 3) uint8 → (B, H', W', 3) float32, resized + mean-subtracted.

    The plain version: ``Wy · x · Wxᵀ`` as two float32 einsums (H first)."""
    B, H, W, C = frames_u8.shape
    Ho, Wo = out_hw
    dev = frames_u8.device
    wy = torch.from_numpy(_resize_matrix(H, Ho)).to(dev)
    wx = torch.from_numpy(_resize_matrix(W, Wo)).to(dev)
    x = frames_u8.float()
    x = torch.einsum("ph,bhwc->bpwc", wy, x)
    x = torch.einsum("qw,bpwc->bpqc", wx, x)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=dev)
    return (x - mean) * pixel_scale


def fused_resize_normalize_kernel(frames_u8, out_hw, pixel_mean=PIXEL_MEAN,
                                  pixel_scale: float = 1.0):
    """Resize + normalize: plain version on the CPU, kernel E on the card.

    CUDA tensors launch the kernel (``fused_resize_normalize_kernel.launches``
    counts the launches) or raise; nothing falls back to the plain version."""
    if frames_u8.device.type == "cpu":
        return fused_resize_normalize(frames_u8, out_hw, pixel_mean, pixel_scale)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"resize_normalize: frames on {frames_u8.device}")
    if frames_u8.dtype != torch.uint8:
        raise TypeError(f"resize_normalize takes uint8 frames, got {frames_u8.dtype}")
    if frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"resize_normalize takes (B, H, W, 3) frames, got {tuple(frames_u8.shape)}")
    if len(pixel_mean) != 3:
        raise ValueError("pixel_mean needs one value per channel")
    B, H, W, _ = frames_u8.shape
    Ho, Wo = (int(v) for v in out_hw)
    if min(B, H, W, Ho, Wo) < 1:
        raise ValueError(f"empty resize: {tuple(frames_u8.shape)} → {(Ho, Wo)}")
    dev = frames_u8.device
    frames_u8 = frames_u8.contiguous()
    ty, tx = _device_taps(H, Ho, dev), _device_taps(W, Wo, dev)
    out = torch.empty((B, Ho, Wo, 3), dtype=torch.float32, device=dev)
    fn = build.load("resize_normalize")
    rc = fn(
        frames_u8.data_ptr(), *(t.data_ptr() for t in ty), *(t.data_ptr() for t in tx),
        out.data_ptr(), B, H, W, Ho, Wo, *(float(m) for m in pixel_mean), float(pixel_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch("resize_normalize", rc)
    fused_resize_normalize_kernel.launches += 1
    return out


fused_resize_normalize_kernel.launches = 0
