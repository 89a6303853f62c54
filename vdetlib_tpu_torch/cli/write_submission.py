"""VID submission writer: det_protos → ILSVRC txt (global frame numbering).

Counterpart of ``python -m vdetlib_tpu write_submission``, with the same
flags (host code; no device). ``--calibration`` applies a fitted Platt
mapping (``calibrate --method platt --save_model``) so the submitted scores
are TP probabilities: per-class AP is unchanged (the mapping is monotone per
class), and a ``--min_score`` cutoff becomes a precision knob instead of an
arbitrary raw-score threshold.
"""

from __future__ import annotations

import argparse
import json

from vdetlib_tpu_torch.evaluation.submission import write_submission
from vdetlib_tpu_torch.protos import proto_load


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output")
    p.add_argument("--pairs", nargs="+", required=True,
                   help="alternating vid_proto det_proto paths (vid1 det1 vid2 det2 ...)")
    p.add_argument("--calibration", default=None,
                   help="fitted Platt parameter JSON (from `calibrate --method platt "
                        "--save_model`); scores are emitted as calibrated TP probabilities")
    p.add_argument("--min_score", type=float, default=0.0,
                   help="drop score entries below this (applied AFTER calibration)")
    args = p.parse_args(argv)
    if len(args.pairs) % 2:
        raise SystemExit("--pairs needs an even number of paths")
    vids = [proto_load(p_) for p_ in args.pairs[0::2]]
    dets = [proto_load(p_) for p_ in args.pairs[1::2]]
    if args.calibration:
        from vdetlib_tpu_torch.evaluation.calibration import PlattCalibrator

        with open(args.calibration, "r", encoding="utf-8") as f:
            cal = PlattCalibrator.from_json(json.load(f))
        dets = [cal.transform(d) for d in dets]
    n = write_submission(dets, vids, args.output, min_score=args.min_score)
    print(f"wrote {args.output}: {n} lines over {len(vids)} videos")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
