"""Per-frame per-class NMS over a det_proto (the suppression tool).

Counterpart of ``python -m vdetlib_tpu frame_nms``, with the same flags plus
``--device``: JSON protos in and out; ``--backend host`` needs no device,
``xla`` and ``pallas`` run the NMS kernels on the card (``--device cpu`` runs
their plain versions instead), ``fixpoint`` the Jacobi form's batched
products there.
"""

from __future__ import annotations

import argparse

from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load
from vdetlib_tpu_torch.utils.log import StageMetrics
from vdetlib_tpu_torch.video.frame_nms import BACKENDS, frame_nms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file", help="input vid_proto")
    p.add_argument("det_file", help="input det_proto")
    p.add_argument("output", help="output det_proto")
    p.add_argument("--thresh", type=float, default=0.3, help="IoU threshold")
    p.add_argument("--backend", choices=BACKENDS, default="host")
    p.add_argument("--max_boxes", type=int, default=512, help="device padding budget")
    p.add_argument("--device", default="cuda", help="device of the xla, pallas and fixpoint backends")
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    if proto_exists(args.output) and not args.overwrite:
        print(f"skip (exists): {args.output}")
        return 0
    metrics = StageMetrics("frame_nms")
    vid = proto_load(args.vid_file)
    det = proto_load(args.det_file)
    out = frame_nms(vid, det, thresh=args.thresh, backend=args.backend,
                    max_boxes=args.max_boxes, device=args.device)
    proto_dump(out, args.output)
    metrics.set("frames", len(vid["frames"]))
    metrics.set("dets_in", len(det["detections"]))
    metrics.set("dets_out", len(out["detections"]))
    metrics.finish()
    print(f"wrote {args.output}: {len(out['detections'])} detections "
          f"(from {len(det['detections'])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
