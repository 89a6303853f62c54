"""Motion-guided propagation stage: vid_proto + det_proto → det_proto.

Counterpart of ``python -m vdetlib_tpu mgp``, with the same flags plus
``--device`` (default ``cuda``, where the flow is kernel A; ``--device cpu``
runs its plain version). The frames are read from the vid_proto's files.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file")
    p.add_argument("det_file")
    p.add_argument("output")
    p.add_argument("--window", type=int, default=1)
    p.add_argument("--score_decay", type=float, default=0.9)
    p.add_argument("--nms_thresh", type=float, default=0.3)
    p.add_argument("--max_boxes", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=31)
    p.add_argument("--no_nms", action="store_true")
    p.add_argument("--image_hw", type=int, nargs=2, default=None)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load

    if proto_exists(args.output) and not args.overwrite:
        print(f"skip (exists): {args.output}")
        return 0

    from vdetlib_tpu_torch.video.mgp import MGPOptions, mgp

    vid = proto_load(args.vid_file)
    det = proto_load(args.det_file)
    opts = MGPOptions(
        window=args.window,
        score_decay=args.score_decay,
        nms_thresh=args.nms_thresh,
        max_boxes=args.max_boxes,
        num_classes=args.num_classes,
        run_nms=not args.no_nms,
        image_hw=tuple(args.image_hw) if args.image_hw else None,
    )
    out = mgp(vid, det, opts=opts, device=args.device)
    proto_dump(out, args.output)
    print(f"wrote {args.output}: {len(out['detections'])} detections")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
