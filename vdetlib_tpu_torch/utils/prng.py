"""JAX's default key stream in numpy: ``PRNGKey``, ``split``, ``bits`` and
``normal`` as ``jax.random`` computes them for a raw threefry2x32 key.

The perturbation stage (``video/perturb.py``) draws its box jitter from this
stream so that the port perturbs the same boxes as the JAX package for the
same ``seed``. It follows ``jax.random`` of JAX 0.9 with
``jax_threefry_partitionable`` on (that version's default) and 64-bit mode
off:

- a key is two uint32 words; ``PRNGKey(seed)`` is ``[seed >> 32, seed mod
  2^32]`` (``[0, seed mod 2^32]`` for a 32-bit seed);
- ``split`` and ``bits`` hash the flat row-major index of each output
  position, as a 64-bit counter split into (high, low) words
  (``iota_2x32_shape``), with threefry2x32 under the key; 32-bit bits are
  the two output words XORed, a key is the two words;
- ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2)
  and maps it onto [lo, hi); ``normal`` is √2·erfinv(uniform on
  (nextafter(-1, 0), 1)) in float32.

Bits and keys are exact. ``normal`` computes erfinv in float64 and rounds
once; XLA's float32 erfinv is a polynomial, so draws differ from JAX's by a
few float32 ulps, more in the far tails.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "bits", "normal", "split", "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key of an integer seed → (2,) uint32."""
    seed = int(seed)
    high = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & _MASK
    return np.array([high, seed & _MASK], dtype=np.uint32)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` (uint32
    arrays of one shape) under ``key`` → the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hash_positions(key, shape):
    """threefry2x32 of every position's flat index (``iota_2x32_shape``)."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                        (idx & np.uint64(_MASK)).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` → (num, 2) uint32 keys."""
    b0, b1 = _hash_positions(key, (num,))
    return np.stack([b0, b1], axis=-1)


def bits(key, shape) -> np.ndarray:
    """``jax.random.bits`` at 32 bits → uint32 of ``shape``."""
    b0, b1 = _hash_positions(key, tuple(shape))
    return b0 ^ b1


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mant = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` in float32 (see the module docstring for its
    last bits)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = torch.from_numpy(uniform(key, shape, lo, 1.0).astype(np.float64))
    return (torch.erfinv(u) * np.sqrt(2.0)).to(torch.float32).numpy()
