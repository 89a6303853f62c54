"""Tubelet tracking stage: vid_proto + det_proto → track_proto.

Counterpart of ``python -m vdetlib_tpu track``, with the same flags plus
``--device`` (default ``cuda``, where each round's scan is one launch of
kernel F; ``--device cpu`` runs the plain loop). ``--weights`` loads a
checkpoint of the port (``pipeline/checkpoint.py``); without it the weights
are random, drawn from ``--seed``. With detection snapping (``--snap_weight``
> 0) each round's scan runs the plain loop on the card too, as the JAX tool
runs its XLA scan: kernel F has no snapping path.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file")
    p.add_argument("det_file")
    p.add_argument("output")
    p.add_argument("--weights", default=None,
                   help="TrackerNet checkpoint (pipeline/checkpoint.py format)")
    p.add_argument("--max_tracks", type=int, default=32)
    p.add_argument("--anchors_per_round", type=int, default=8)
    p.add_argument("--anchor_thresh", type=float, default=0.3)
    p.add_argument("--conf_thresh", type=float, default=0.5)
    p.add_argument("--cover_thresh", type=float, default=0.5)
    p.add_argument("--snap_weight", type=float, default=0.0,
                   help="detection snapping: blend tracked boxes toward the "
                        "best overlapping same-frame detection (0 = off)")
    p.add_argument("--snap_iou", type=float, default=0.5)
    p.add_argument("--image_hw", type=int, nargs=2, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load

    if proto_exists(args.output) and not args.overwrite:
        print(f"skip (exists): {args.output}")
        return 0

    import torch

    from vdetlib_tpu_torch import weights
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.checkpoint import load_params
    from vdetlib_tpu_torch.video.track import TrackOptions, track_from_det

    vid = proto_load(args.vid_file)
    det = proto_load(args.det_file)
    cfg = TrackerConfig()
    model = weights.init_tracker(cfg, torch.Generator().manual_seed(args.seed), device=args.device)
    if args.weights:
        load_params(args.weights, model)
    opts = TrackOptions(
        max_tracks=args.max_tracks,
        anchors_per_round=args.anchors_per_round,
        anchor_thresh=args.anchor_thresh,
        conf_thresh=args.conf_thresh,
        cover_thresh=args.cover_thresh,
        snap_weight=args.snap_weight,
        snap_iou=args.snap_iou,
        image_hw=tuple(args.image_hw) if args.image_hw else None,
    )
    tp = track_from_det(model, vid, det, cfg, opts)
    proto_dump(tp, args.output)
    print(f"wrote {args.output}: {len(tp['tracks'])} tracks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
