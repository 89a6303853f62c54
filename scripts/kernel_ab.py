#!/usr/bin/env python3
"""Time hand kernels of one tree of the port by device time, on the card.

    python3 scripts/kernel_ab.py [--tree DIR] [--kernels nms_sorted nms_grouped ...]

Runs ``chip_smoke.py``'s phase-3 cases of the named kernels (each checked
against its plain version, then timed: wall per call by CUDA events, device
time by torch.profiler, host time per call; kernel D by the device time of
the whole call, its kernel and any torch work around it) with the ``vdetlib_tpu_torch``
of ``--tree`` (default: this checkout) first on ``sys.path``; the timing code
is always this checkout's ``chip_smoke.py``. For an A/B, unpack the other
commit with ``git archive`` into a git-ignored directory and run the two
trees in turns, each in its own process, in one call on one card:

    for t in _checkout/parent . . _checkout/parent; do
        python3 scripts/kernel_ab.py --tree $t; done

The last line is one JSON object: the tree, the card, and each kernel's
record from its case.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = {"flow_level": "flow_case", "nms_grouped": "grouped_case", "nms_batched": "batched_case",
         "nms_sorted": "sorted_case", "resize_normalize": "resize_case",
         "track_scan": "track_scan_case", "seq_nms": "seq_nms_case"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT), help="root of the tree whose kernels run")
    ap.add_argument("--kernels", nargs="+", default=["nms_sorted"],
                    choices=sorted(CASES))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    if not (tree / "vdetlib_tpu_torch").is_dir():
        print(f"kernel_ab: no vdetlib_tpu_torch under {tree}", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(tree))  # the tree's package, imported lazily by the cases

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; the kernels run only on the card", file=sys.stderr)
        return 1
    import vdetlib_tpu_torch

    assert Path(vdetlib_tpu_torch.__file__).resolve().is_relative_to(tree), \
        f"imported {vdetlib_tpu_torch.__file__}, not the tree's package"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vdetlib_tpu_torch.kernels import build

    build.build_all()
    dev = torch.device("cuda", 0)
    card = smoke.gpu_name_and_power()
    smoke.log(f"tree {tree}, card {card}")
    times, records = [], {}
    for name in args.kernels:
        records[name] = getattr(smoke, CASES[name])(dev, times)
    print(json.dumps({"tree": str(tree), "card": card, "kernels": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
