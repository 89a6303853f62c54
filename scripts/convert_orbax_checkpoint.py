#!/usr/bin/env python
"""Convert an Orbax checkpoint of the JAX package into a checkpoint of the
PyTorch port.

    python scripts/convert_orbax_checkpoint.py {detector,tracker} ORBAX_DIR OUT.pt

``ORBAX_DIR`` is a directory written by ``vdetlib_tpu.pipeline.checkpoint.save_params``
(for example by ``python -m vdetlib_tpu train_detector`` or ``train_tracker``).
The tree is restored without a template, its leaves become numpy arrays, and
``vdetlib_tpu_torch.weights.detector_state_from_flax`` /
``tracker_state_from_flax`` map it onto the port's ``Detector`` /
``TrackerNet``; ``vdetlib_tpu_torch.pipeline.checkpoint.save_params`` writes
``OUT.pt``, which every weight flag of the port's tools reads
(``detect --weights``, ``track --weights``, ``stream`` and ``pipeline
--detector_weights/--tracker_weights``).

This script needs JAX and orbax-checkpoint, so it runs on a machine that has
them (the one that trained the model); the GPU machine that runs the port
needs neither. The port itself imports neither: this is the only way a
JAX-trained model reaches the card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(kind: str, orbax_dir: str, out: str) -> dict:
    """Restore ``orbax_dir``, convert it for ``kind`` and write ``out``; returns
    the state_dict written."""
    import jax
    import numpy as np

    from vdetlib_tpu.pipeline.checkpoint import load_params as orbax_load
    from vdetlib_tpu_torch.pipeline.checkpoint import save_params
    from vdetlib_tpu_torch.weights import detector_state_from_flax, tracker_state_from_flax

    tree = jax.tree.map(np.asarray, orbax_load(orbax_dir))
    to_state = {"detector": detector_state_from_flax, "tracker": tracker_state_from_flax}[kind]
    sd = to_state(tree)
    save_params(out, sd)
    return sd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=["detector", "tracker"])
    p.add_argument("orbax_dir")
    p.add_argument("out")
    args = p.parse_args(argv)
    if not os.path.isdir(args.orbax_dir):
        raise SystemExit(f"{args.orbax_dir}: not an Orbax checkpoint directory")
    sd = convert(args.kind, args.orbax_dir, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {args.out}: {args.kind}, {len(sd)} tensors, {n} parameters")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
