"""Seq-NMS suppression stage: vid + det protos → det_proto (+ tubelets).

Counterpart of ``python -m vdetlib_tpu seq_nms``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU) and
``--backend`` (``device``: the batched seq-NMS on ``--device``; ``host``:
the numpy loop, which uses no device).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file")
    p.add_argument("det_file")
    p.add_argument("output", help="suppressed det_proto")
    p.add_argument("--track_output", default=None, help="tubelet track_proto")
    p.add_argument("--link_thresh", type=float, default=0.5)
    p.add_argument("--suppress_thresh", type=float, default=0.3)
    p.add_argument("--max_paths", type=int, default=100)
    p.add_argument("--rescore", choices=["avg", "max"], default="avg")
    p.add_argument("--max_boxes", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=31)
    p.add_argument("--min_score", type=float, default=0.0)
    p.add_argument("--backend", choices=["device", "host"], default="device")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load

    if proto_exists(args.output) and not args.overwrite:
        print(f"skip (exists): {args.output}")
        return 0

    from vdetlib_tpu_torch.video.link import LinkOptions, seq_nms_video

    vid = proto_load(args.vid_file)
    det = proto_load(args.det_file)
    opts = LinkOptions(
        link_thresh=args.link_thresh,
        suppress_thresh=args.suppress_thresh,
        max_paths=args.max_paths,
        rescore=args.rescore,
        max_boxes=args.max_boxes,
        num_classes=args.num_classes,
        min_score=args.min_score,
        backend=args.backend,
    )
    det_out, track_out = seq_nms_video(vid, det, opts, device=args.device)
    proto_dump(det_out, args.output)
    print(f"wrote {args.output}: {len(det_out['detections'])} detections")
    if args.track_output:
        proto_dump(track_out, args.track_output)
        print(f"wrote {args.track_output}: {len(track_out['tracks'])} tubelets")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
