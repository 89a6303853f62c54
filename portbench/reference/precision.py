"""Number formats of the reference's stages, and the one-step-lower control.

A stage's format says how the operands of its products are rounded and in
which type the product is formed:

- ``float32``: operands and products in float32 (TF32 off);
- ``tf32``: operands rounded to TF32's 10-bit mantissa, products in float32;
- ``bf16``: operands and products in bfloat16 (cuDNN and cuBLAS accumulate
  in float32 inside);
- ``fp8``: operands rounded to float8 e4m3 (saturated at +-448), products
  in bfloat16, as an fp8 matmul with a wider accumulator gives them.

:data:`LOWER` is the ladder the control takes one step down: float32 with
TF32 off goes to TF32, bfloat16 to fp8.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0
LOWER = {"float32": "tf32", "bf16": "fp8"}


class Prec:
    """One stage's format (see the module docstring)."""

    def __init__(self, name: str):
        if name not in ("float32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown number format {name!r}")
        self.name = name

    @property
    def dtype(self) -> torch.dtype:
        """The type products are formed in."""
        return torch.float32 if self.name in ("float32", "tf32") else torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to this format, in :attr:`dtype`."""
        if self.name == "float32":
            return x.float()
        if self.name == "bf16":
            return x.to(torch.bfloat16)
        if self.name == "tf32":
            bits = x.float().contiguous().view(torch.int32)
            # round to nearest on the 13 dropped mantissa bits
            bits = (bits + 0x1000) & ~0x1FFF
            return bits.view(torch.float32)
        x8 = x.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
        return x8.to(torch.bfloat16)

    def __repr__(self) -> str:
        return self.name


SHARED = ("flow", "tracker_features", "tracker_search_pool", "tracker_template", "tracker_corr")


class Precisions:
    """Every stage's format, as a configuration file's ``precision`` states
    it, one attribute a stage (``prec.flow``); frozen."""

    def __init__(self, **formats: Prec):
        self.__dict__.update(formats)

    def __setattr__(self, name, value):
        raise AttributeError("Precisions is frozen")

    def __repr__(self) -> str:
        return "Precisions(" + ", ".join(f"{k}={v!r}" for k, v in vars(self).items()) + ")"

    @classmethod
    def from_config(cls, spec: dict, stages, lower: bool = False) -> "Precisions":
        """From a ``precision`` mapping that states exactly the shared stages
        and ``stages`` (the architecture's); ``lower`` takes each one step
        down."""
        names = set(SHARED) | set(stages)
        if set(spec) != names:
            raise ValueError(f"precision needs exactly the stages {sorted(names)}")
        return cls(**{k: Prec(LOWER[v] if lower else v) for k, v in spec.items()})
