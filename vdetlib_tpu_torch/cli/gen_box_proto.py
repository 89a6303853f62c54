"""Convert precomputed proposals (.mat/.npz/box_proto) → box_proto.

Counterpart of ``python -m vdetlib_tpu gen_box_proto``, with the same flags
(host code; no device): Selective Search / EdgeBoxes .mat files become
box_protos (``video/proposal.py``), with optional cross-frame reuse.
"""

from __future__ import annotations

import argparse

from vdetlib_tpu_torch.protos import proto_dump
from vdetlib_tpu_torch.video.proposal import load_proposals, reuse_across_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help=".mat / .npz / box_proto json")
    p.add_argument("output", help="output box_proto path")
    p.add_argument("--video", required=True)
    p.add_argument("--order", choices=["xyxy", "yxyx"], default="yxyx",
                   help="input coordinate order (.mat; SS uses yxyx)")
    p.add_argument("--zero_based", action="store_true",
                   help="input is 0-based (default: 1-based MATLAB)")
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--reuse_window", type=int, default=0,
                   help="copy proposals into +-w neighboring frames")
    args = p.parse_args(argv)

    kw = {}
    if args.input.endswith(".mat"):
        kw = {"order": args.order, "one_based": not args.zero_based, "top_k": args.top_k}
    elif args.top_k:
        kw = {"top_k": args.top_k}
    proto = load_proposals(args.input, args.video, **kw)
    if args.reuse_window:
        proto = reuse_across_frames(proto, args.reuse_window)
    proto_dump(proto, args.output)
    print(f"wrote {args.output}: {len(proto['boxes'])} proposals")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
