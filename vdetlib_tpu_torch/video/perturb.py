"""Tubelet box perturbation options — counterpart of ``vdetlib_tpu/video/perturb.py``.

Only ``PerturbOptions`` is ported (the pipeline config tree carries it when
``--stages`` names ``perturb``); the stage itself (perturbed boxes re-scored
by the detector and max-pooled) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PerturbOptions"]


@dataclass(frozen=True)
class PerturbOptions:
    """Same fields and defaults as the JAX ``PerturbOptions``."""

    num_perturb: int = 8  # perturbations per tubelet box (incl. identity)
    shift_sigma: float = 0.05  # stddev of center shift, in box-size units
    scale_sigma: float = 0.10  # stddev of log-scale jitter
    take_best_box: bool = True  # move the tubelet box to the best perturbation
    seed: int = 0
