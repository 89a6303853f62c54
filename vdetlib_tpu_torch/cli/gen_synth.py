"""Generate a synthetic video dataset (frames + vid/box/annot protos).

Counterpart of ``python -m vdetlib_tpu gen_synth``, with the same flags
(host code; no device; the JPEG frames need ``cv2``): N deterministic
videos of moving textured objects with ground truth, in the on-disk layout
the pipeline tools read (``data/synth.py``).
"""

from __future__ import annotations

import argparse
import os

from vdetlib_tpu_torch.data.synth import (SynthConfig, annot_proto, box_proto,
                                          det_proto_from_gt, hard_config, make_video,
                                          write_frames)
from vdetlib_tpu_torch.protos import proto_dump


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--num_videos", type=int, default=4)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--proposals", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_dets", action="store_true", help="also emit synthetic det_protos")
    p.add_argument("--class_coded", action="store_true",
                   help="class-coded appearance (classification learnable across videos)")
    p.add_argument("--scale_rate", type=float, default=0.0,
                   help="per-frame relative object size change (e.g. 0.035 = objects zoom "
                        "~3.5%%/frame; exercises scale-adaptive tracking)")
    p.add_argument("--tier", default="easy", choices=["easy", "hard"],
                   help="hard: crossing/occluded objects, camouflaged occluder bars, "
                        "flickering distractors, camera pan+jitter, appearance drift, low "
                        "contrast (data/synth.py::hard_config)")
    p.add_argument("--num_objects", type=int, default=None,
                   help="objects per video (default: tier preset)")
    p.add_argument("--dropout_windows", type=int, default=0,
                   help="synthetic det_protos (--with_dets): per-object count of blind "
                        "windows (occlusion-shaped oracle-detector failures)")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(args.num_videos):
        name = f"synth{i:03d}"
        common = dict(num_frames=args.frames, height=args.height, width=args.width,
                      num_classes=args.num_classes, proposals_per_frame=args.proposals,
                      seed=args.seed + i, scale_rate=args.scale_rate)
        if args.num_objects is not None:
            common["num_objects"] = args.num_objects
        if args.tier == "hard":
            cfg = hard_config(**common)
        else:
            cfg = SynthConfig(class_coded_appearance=args.class_coded, **common)
        sv = make_video(cfg, video=name)
        vid = write_frames(sv, os.path.join(args.out_dir, "frames"))
        proto_dump(vid, os.path.join(args.out_dir, f"{name}.vid.json"))
        proto_dump(box_proto(sv), os.path.join(args.out_dir, f"{name}.box.json"))
        proto_dump(annot_proto(sv), os.path.join(args.out_dir, f"{name}.annot.json"))
        if args.with_dets:
            proto_dump(det_proto_from_gt(sv, dropout_windows=args.dropout_windows),
                       os.path.join(args.out_dir, f"{name}.det.json"))
        print(f"{name}: {args.frames} frames")
    print(f"dataset at {args.out_dir}: {args.num_videos} videos")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
