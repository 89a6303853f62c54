"""VID mAP evaluation: det_protos vs annot_protos → per-class AP + mAP.

Counterpart of ``python -m vdetlib_tpu eval_vid``, with the same flags and
output (host code; no device)."""

from __future__ import annotations

import argparse
import json

from vdetlib_tpu_torch.evaluation.vid_map import vid_map
from vdetlib_tpu_torch.protos import proto_load


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", nargs="+", required=True,
                   help="alternating det_proto annot_proto paths (det1 annot1 det2 annot2 ...)")
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--json_out", default=None)
    args = p.parse_args(argv)
    if len(args.pairs) % 2:
        raise SystemExit("--pairs needs an even number of paths")
    pairs = [(proto_load(d), proto_load(a))
             for d, a in zip(args.pairs[0::2], args.pairs[1::2])]
    m, aps = vid_map(pairs, iou_thresh=args.iou_thresh)
    for ci in sorted(aps):
        print(f"class {ci}: AP = {aps[ci]:.4f}")
    print(f"mAP = {m:.4f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"mAP": m, "per_class": aps}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
