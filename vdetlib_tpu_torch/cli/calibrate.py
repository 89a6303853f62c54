"""Calibrate final det_proto scores for pooled multi-video evaluation.

Counterpart of ``python -m vdetlib_tpu calibrate``, with the same flags
(host code; no device). Two modes (``evaluation/calibration.py``):

- rank (default, label-free): per-video per-class quantile transform.
- platt: fit per-class logistic calibration on a labeled validation split
  (--val_dets/--val_annots), save (--save_model) or apply (--load_model)
  the fitted mapping.

Examples:
  python -m vdetlib_tpu_torch calibrate out/*/final.json --suffix .cal.json
  python -m vdetlib_tpu_torch calibrate out/*/final.json --method platt \\
      --val_dets val/*/final.json --val_annots val/*.annot.json --save_model cal.json
"""

from __future__ import annotations

import argparse
import json
import os

from vdetlib_tpu_torch.evaluation.calibration import PlattCalibrator, rank_normalize
from vdetlib_tpu_torch.protos import proto_dump, proto_load


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dets", nargs="+", help="final det_proto files to calibrate")
    p.add_argument("--method", default="rank", choices=["rank", "platt"])
    p.add_argument("--blend", type=float, default=0.0,
                   help="rank: new = (1-blend)*quantile + blend*raw — 0 is a pure rank "
                        "transform (junk-only videos get promoted); raise to keep "
                        "cross-video evidence")
    p.add_argument("--suffix", default=".cal.json",
                   help="output path = input path minus .json + suffix")
    p.add_argument("--val_dets", nargs="*", default=[],
                   help="platt: validation det protos (ordered)")
    p.add_argument("--val_annots", nargs="*", default=[],
                   help="platt: matching annot protos (same order)")
    p.add_argument("--save_model", default=None,
                   help="platt: write fitted parameters to this JSON")
    p.add_argument("--load_model", default=None,
                   help="platt: apply a previously fitted parameter JSON")
    args = p.parse_args(argv)

    if args.method == "platt":
        if args.load_model:
            with open(args.load_model, "r", encoding="utf-8") as f:
                cal = PlattCalibrator.from_json(json.load(f))
        else:
            if len(args.val_dets) != len(args.val_annots) or not args.val_dets:
                raise SystemExit("--method platt needs matching --val_dets/--val_annots "
                                 "(or --load_model)")
            pairs = [(proto_load(d), proto_load(a))
                     for d, a in zip(args.val_dets, args.val_annots)]
            cal = PlattCalibrator().fit(pairs)
            if args.save_model:
                with open(args.save_model, "w") as f:
                    json.dump(cal.to_json(), f)
        transform = cal.transform
    else:
        def transform(dp):
            return rank_normalize(dp, blend=args.blend)

    for path in args.dets:
        out = transform(proto_load(path))
        base = path[:-8] if path.endswith(".json.gz") else (
            path[:-5] if path.endswith(".json") else path)
        out_path = base + args.suffix
        proto_dump(out, out_path)
        print(f"{os.path.basename(path)} -> {os.path.basename(out_path)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
