"""Streaming (online) pipeline — process a video chunk by chunk.

Counterpart of ``python -m vdetlib_tpu stream``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU with the
kernels' plain versions). Frames are consumed in fixed-size chunks with
detection, MGP and tracking state carried across chunk boundaries; at the
end of the stream the collected arrays become the protos the batch pipeline
writes:

  <workdir>/NAME/final.json     seq-NMS det proto (path statistics)
  <workdir>/NAME/tubelets.json  seq-NMS tubelets (one track per class+path)
  <workdir>/NAME/track.json     online-tracker track proto (stream_tracker)

Inputs: NAME.vid.json (+ NAME.box.json proposals next to it, or
--box_suffix), as positional paths or line by line on stdin (--stdin).
--detector_weights / --tracker_weights load checkpoints of the port
(pipeline/checkpoint.py); without them the weights are random, drawn from
--seed.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("inputs", nargs="*", help="vid_proto paths (or use --stdin)")
    p.add_argument("workdir")
    p.add_argument("--stdin", action="store_true",
                   help="read vid_proto paths line by line from stdin "
                        "(streaming queue mode; blank line or EOF ends)")
    p.add_argument("--box_suffix", default=".box.json",
                   help="proposal proto path = vid path minus .vid.json + this")
    p.add_argument("--detector_weights", default=None)
    p.add_argument("--tracker_weights", default=None)
    p.add_argument("--model", default="tiny",
                   choices=["base", "small", "tiny", "rfcn_r101", "rfcn_tiny"])
    p.add_argument("--num_classes", type=int, default=31)
    p.add_argument("--image_hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--max_rois", type=int, default=64)
    p.add_argument("--chunk", type=int, default=32, help="frames per step (online latency unit)")
    p.add_argument("--track_slots", type=int, default=16)
    p.add_argument("--seed_thresh", type=float, default=0.4)
    p.add_argument("--conf_thresh", type=float, default=0.3)
    p.add_argument("--min_score", type=float, default=0.0)
    p.add_argument("--track_stride", type=int, default=1,
                   help="advance the online NCC scan every s-th frame (1=frame-exact, "
                        "2=half the tracker compute; skipped frames interpolate)")
    p.add_argument("--no_mgp", action="store_true")
    p.add_argument("--no_backtrack", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vdetlib_tpu_torch.data.loader import FrameLoader, load_frame
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.checkpoint import load_params
    from vdetlib_tpu_torch.protos import proto_dump, proto_exists, proto_load
    from vdetlib_tpu_torch.protos.accessors import frame_path_at
    from vdetlib_tpu_torch.protos.arrays import box_proto_to_arrays
    from vdetlib_tpu_torch.utils.log import get_logger
    from vdetlib_tpu_torch.video.stream import StreamOptions, stream_to_protos, stream_video
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    log = get_logger("stream")
    hw = tuple(args.image_hw)
    det_model = init_detector(detector_preset(args.model, num_classes=args.num_classes),
                              torch.Generator().manual_seed(args.seed), device=args.device)
    trk_cfg = TrackerConfig()
    trk_model = init_tracker(trk_cfg, torch.Generator().manual_seed(args.seed + 1),
                             device=args.device)
    if args.detector_weights:
        load_params(args.detector_weights, det_model)
    if args.tracker_weights:
        load_params(args.tracker_weights, trk_model)
    opts = StreamOptions(
        chunk=args.chunk,
        max_rois=args.max_rois,
        num_classes=args.num_classes,
        track_slots=args.track_slots,
        seed_thresh=args.seed_thresh,
        conf_thresh=args.conf_thresh,
        mgp=not args.no_mgp,
        backtrack=not args.no_backtrack,
        track_stride=args.track_stride,
    )

    def process(vid_path: str) -> None:
        vid = proto_load(vid_path)
        name = vid["video"]
        vdir = os.path.join(args.workdir, name)
        final_path = os.path.join(vdir, "final.json")
        if proto_exists(final_path) and not args.overwrite:
            log.info("skip %s (final exists)", name)
            return
        base = (vid_path[: -len(".vid.json")] if vid_path.endswith(".vid.json")
                else os.path.splitext(vid_path)[0])
        box_path = base + args.box_suffix
        if not os.path.exists(box_path):
            raise SystemExit(f"{name}: streaming needs proposals at {box_path}")
        box = proto_load(box_path)
        fids = [f["frame"] for f in vid["frames"]]
        # one decode scale per video
        _, scale = load_frame(frame_path_at(vid, fids[0]), hw)
        sy, sx = scale
        rois, _ = box_proto_to_arrays(box, fids, args.max_rois)
        rois = rois * np.array([sx, sy, sx, sy], np.float32)
        loader = FrameLoader(vid, target_hw=hw)

        def chunks():
            buf = []
            for _, img, sc in loader.iter_frames():
                if sc != (sy, sx):
                    raise SystemExit(f"{name}: varying decode scales within the video")
                buf.append(img)
                if len(buf) == opts.chunk:
                    yield np.stack(buf)
                    buf = []
            if buf:
                yield np.stack(buf)

        result = stream_video(det_model, trk_model, trk_cfg, chunks(), rois, opts)
        loader.close()
        # back to native pixel space before emitting protos
        inv = np.array([1 / sx, 1 / sy, 1 / sx, 1 / sy], np.float32)
        result["boxes"] = result["boxes"] * inv
        result["tracks"] = {
            tid: [(t, np.asarray(b) * inv, s) for t, b, s in seg]
            for tid, seg in result["tracks"].items()
        }
        det_proto, tubelets, track_proto = stream_to_protos(result, fids, name,
                                                            min_score=args.min_score)
        os.makedirs(vdir, exist_ok=True)
        proto_dump(track_proto, os.path.join(vdir, "track.json"))
        proto_dump(tubelets, os.path.join(vdir, "tubelets.json"))
        proto_dump(det_proto, final_path)
        log.info("streamed %s: %d frames in %d-frame chunks, %d final dets, %d tubelets, "
                 "%d online tracks", name, result["num_frames"], opts.chunk,
                 len(det_proto["detections"]), len(tubelets["tracks"]),
                 len(track_proto["tracks"]))

    os.makedirs(args.workdir, exist_ok=True)
    if args.stdin:
        # queue mode is a daemon loop: one bad video is logged and skipped
        for line in sys.stdin:
            line = line.strip()
            if not line:
                break
            try:
                process(line)
            except (Exception, SystemExit) as e:
                log.warning("skip %s: %s", line, e)
    else:
        if not args.inputs:
            raise SystemExit("no inputs (pass vid_proto paths or --stdin)")
        for vid_path in args.inputs:
            process(vid_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
