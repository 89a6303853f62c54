"""Per-frame detection stage: vid_proto + box_proto → det_proto.

Counterpart of ``python -m vdetlib_tpu detect``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU with the
kernels' plain versions). ``--weights`` loads a checkpoint of the port
(``pipeline/checkpoint.py``; convert a JAX one with
``scripts/convert_orbax_checkpoint.py``); without it the weights are random,
drawn from ``--seed``.
``--pyramid`` scales other than 1.0 resize the frames on the device.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file")
    p.add_argument("box_file")
    p.add_argument("output")
    p.add_argument("--weights", default=None,
                   help="detector checkpoint (pipeline/checkpoint.py format)")
    p.add_argument("--model", default="base",
                   choices=["base", "small", "tiny", "rfcn_r101", "rfcn_tiny"])
    p.add_argument("--num_classes", type=int, default=31)
    p.add_argument("--image_hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_rois", type=int, default=128)
    p.add_argument("--score_thresh", type=float, default=0.005)
    p.add_argument("--no_regress", action="store_true")
    p.add_argument("--pyramid", type=float, nargs="+", default=[1.0],
                   help="image pyramid scales (scores max-pooled over scales)")
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
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.pipeline.checkpoint import load_params
    from vdetlib_tpu_torch.video.detect import DetectOptions, det_vid

    model = weights.init_detector(detector_preset(args.model, num_classes=args.num_classes),
                                  torch.Generator().manual_seed(args.seed), device=args.device)
    if args.weights:
        load_params(args.weights, model)
    vid = proto_load(args.vid_file)
    boxes = proto_load(args.box_file)
    opts = DetectOptions(
        batch_size=args.batch_size,
        max_rois=args.max_rois,
        image_hw=tuple(args.image_hw),
        score_thresh=args.score_thresh,
        regress=not args.no_regress,
        pyramid=tuple(args.pyramid),
    )
    det = det_vid(model, vid, boxes, opts)
    proto_dump(det, args.output)
    print(f"wrote {args.output}: {len(det['detections'])} detections")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
