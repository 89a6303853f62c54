"""Temporal rescoring stage: vid + det + track protos → score_proto + det_proto.

Counterpart of ``python -m vdetlib_tpu rescore``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU). A
track_proto written by the perturbation stage carries ``perturb_scores``,
which enter the tubelet statistics.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file")
    p.add_argument("det_file")
    p.add_argument("track_file")
    p.add_argument("score_output", help="output score_proto")
    p.add_argument("--det_output", default=None, help="rescored det_proto output")
    p.add_argument("--match_thresh", type=float, default=0.5)
    p.add_argument("--top_ratio", type=float, default=0.5)
    p.add_argument("--boost", choices=["max", "mean"], default="max")
    p.add_argument("--bg_decay", type=float, default=1.0)
    p.add_argument("--min_matched_frac", type=float, default=0.0,
                   help="track-quality gate: a track boosts only if dets "
                        "match >= this fraction of its live frames")
    p.add_argument("--stat_floor", type=int, default=0,
                   help="length prior: top-k mean denominator is at least "
                        "this many frames (damps short flicker tracks)")
    p.add_argument("--max_boxes", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=31)
    p.add_argument("--max_tracks", type=int, default=64)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load

    if proto_exists(args.score_output) and not args.overwrite:
        print(f"skip (exists): {args.score_output}")
        return 0

    from vdetlib_tpu_torch.video.rescore import RescoreOptions, tubelet_rescore

    vid = proto_load(args.vid_file)
    det = proto_load(args.det_file)
    trk = proto_load(args.track_file)
    opts = RescoreOptions(
        match_thresh=args.match_thresh,
        top_ratio=args.top_ratio,
        boost=args.boost,
        bg_decay=args.bg_decay,
        min_matched_frac=args.min_matched_frac,
        stat_floor=args.stat_floor,
        max_boxes=args.max_boxes,
        num_classes=args.num_classes,
        max_tracks=args.max_tracks,
    )
    score_proto, det_out = tubelet_rescore(vid, det, trk, opts, device=args.device)
    proto_dump(score_proto, args.score_output)
    print(f"wrote {args.score_output}: {len(score_proto['tracks'])} tracks")
    if args.det_output:
        proto_dump(det_out, args.det_output)
        print(f"wrote {args.det_output}: {len(det_out['detections'])} detections")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
