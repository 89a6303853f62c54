"""Full T-CNN pipeline over a video set: detect → MGP → track → rescore → seq-NMS.

Counterpart of ``python -m vdetlib_tpu pipeline``, with the same flags and
defaults plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the
CPU with the kernels' plain versions). ``--engine staged`` (the default)
runs each video through the staged stages (``pipeline/runner.py``), a JSON
proto at every stage boundary with per-stage resume-by-existence,
``--staged_workers`` videos at once; ``--engine fused`` runs each video
through the fused pipeline (``pipeline/fused_runner.py``) with
resume-by-existence and ``--fused_group``. Both take ``--keep_going``;
``--eval`` computes the VID mAP against the annotation protos. Weights come
from ``--detector_weights`` / ``--tracker_weights`` (checkpoints of the
port; convert a JAX one with ``scripts/convert_orbax_checkpoint.py``), else
they are random, drawn from ``--seed``.

Both engines run every tracker, flow and rescoring option of the JAX tool:
``--snap_weight``, ``--template_eta``, ``--track_scales``, ``--flow_preset
accurate`` and ``--tubelet_boxes``. ``--multihost`` runs one process per
shard: each starts the process group from torch's environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; NCCL on the card,
gloo with ``--device cpu``) and sweeps its round-robin share of the videos
into the shared workdir; with ``--eval`` every process meets the others at a
barrier once its shard is written, then rank 0 evaluates over every shard's
``final.json`` and the other ranks return 0.

Dataset layout (as produced by ``gen_synth``): ``<data>/NAME.vid.json`` +
``NAME.box.json`` (+ optional ``NAME.annot.json`` for --eval). The frames
are JPEGs decoded with ``cv2``.
"""

from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_dir")
    p.add_argument("workdir")
    p.add_argument("--detector_weights", default=None)
    p.add_argument("--tracker_weights", default=None)
    p.add_argument("--model", default="tiny",
                   choices=["base", "small", "tiny", "rfcn_r101", "rfcn_tiny"])
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--image_hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--max_rois", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mgp_window", type=int, default=1)
    p.add_argument("--flow_preset", default="fastest", choices=["accurate", "fast", "fastest"],
                   help="MGP optical-flow resolution/speed tradeoff")
    p.add_argument("--max_tracks", type=int, default=16)
    p.add_argument("--track_stride", type=int, default=2,
                   help="NCC scan advances every s-th frame, interpolating the rest; "
                        "1 = frame-exact reference semantics")
    p.add_argument("--template_eta", type=float, default=0.0,
                   help="EMA template adaptation rate (0 = frozen anchor template)")
    p.add_argument("--track_scales", type=int, default=1,
                   help="scale-adaptive tracking: NCC scales per step (1 = off)")
    p.add_argument("--stages", default="detect,mgp,track,rescore,seq_nms",
                   help="comma list; insert 'perturb' after track to enable tubelet box "
                        "perturbation + detector max-pooling")
    p.add_argument("--perturb_n", type=int, default=8,
                   help="perturbations per tubelet box (perturb stage)")
    p.add_argument("--tubelet_boxes", action="store_true",
                   help="T-CNN tubelet-box semantics: live track boxes with no matched "
                        "detection enter the det set (both engines)")
    p.add_argument("--anchor_thresh", type=float, default=0.3,
                   help="min det score to seed a track (TrackOptions)")
    p.add_argument("--track_conf", type=float, default=0.5,
                   help="tracker termination confidence (TrackOptions)")
    p.add_argument("--snap_weight", type=float, default=0.0,
                   help="detection snapping blend (0 = off)")
    p.add_argument("--snap_iou", type=float, default=0.5,
                   help="min IoU for detection snapping (see --snap_weight)")
    p.add_argument("--stat_floor", type=int, default=0,
                   help="length prior on the tubelet statistic (0 = off)")
    p.add_argument("--boost", default="max", choices=["max", "mean"],
                   help="rescore boost statistic application")
    p.add_argument("--bg_decay", type=float, default=1.0,
                   help="score multiplier for dets on no tubelet")
    p.add_argument("--min_matched_frac", type=float, default=0.0,
                   help="track-quality gate: min fraction of a track's live frames with a "
                        "matched det (0 = off)")
    p.add_argument("--top_ratio", type=float, default=0.5,
                   help="tubelet statistic = mean of top this-fraction scores")
    p.add_argument("--shard", type=int, nargs=2, default=[0, 1], metavar=("I", "N"))
    p.add_argument("--multihost", action="store_true",
                   help="one process per shard over torch.distributed (MASTER_ADDR, "
                        "MASTER_PORT, WORLD_SIZE, RANK); rank 0 evaluates every shard")
    p.add_argument("--engine", default="staged", choices=["staged", "fused"],
                   help="staged = JSON proto at every stage boundary (per-stage resume); "
                        "fused = the fused pipeline per video, same final protos")
    p.add_argument("--fused_group", type=int, default=1,
                   help="fused engine: videos per group (the port runs a group's videos one "
                        "after another; results equal to 1, byte for byte)")
    p.add_argument("--staged_workers", type=int, default=1,
                   help="staged engine: videos in flight at once, on threads (outputs "
                        "unchanged; 2 ran slower than 1 on an H100, PERF.md)")
    p.add_argument("--keep_going", action="store_true",
                   help="sweep mode: log-and-skip videos that fail (exit code 1 if any "
                        "failed; failed videos are retried on rerun)")
    p.add_argument("--eval", action="store_true", help="compute mAP vs annot protos")
    p.add_argument("--calibrate", default="none", choices=["none", "rank"],
                   help="per-video score calibration before pooled eval ('rank' = "
                        "label-free quantile transform)")
    p.add_argument("--calibrate_blend", type=float, default=0.0,
                   help="rank calibration: (1-blend)*quantile + blend*raw")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to run on")
    return p.parse_args(argv)


def pipeline_config(args):
    """The ``PipelineConfig`` the tool's flags give."""
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.runner import PipelineConfig
    from vdetlib_tpu_torch.video.detect import DetectOptions
    from vdetlib_tpu_torch.video.link import LinkOptions
    from vdetlib_tpu_torch.video.mgp import MGPOptions
    from vdetlib_tpu_torch.video.rescore import RescoreOptions
    from vdetlib_tpu_torch.video.track import TrackOptions

    hw = tuple(args.image_hw)
    trk_cfg = TrackerConfig(num_scales=args.track_scales, template_eta=args.template_eta)
    perturb_opts = None
    if "perturb" in args.stages.split(","):
        from vdetlib_tpu_torch.video.perturb import PerturbOptions

        perturb_opts = PerturbOptions(num_perturb=args.perturb_n)
    return PipelineConfig(
        detect=DetectOptions(batch_size=args.batch_size, max_rois=args.max_rois, image_hw=hw,
                             score_thresh=0.05),
        mgp=MGPOptions(window=args.mgp_window, num_classes=args.num_classes, image_hw=hw,
                       flow_preset=args.flow_preset),
        track=TrackOptions(max_tracks=args.max_tracks, image_hw=hw,
                           anchor_thresh=args.anchor_thresh, conf_thresh=args.track_conf,
                           snap_weight=args.snap_weight, snap_iou=args.snap_iou,
                           frame_stride=args.track_stride),
        tracker_cfg=trk_cfg,
        rescore=RescoreOptions(num_classes=args.num_classes, tubelet_boxes=args.tubelet_boxes,
                               boost=args.boost, bg_decay=args.bg_decay,
                               top_ratio=args.top_ratio,
                               min_matched_frac=args.min_matched_frac,
                               stat_floor=args.stat_floor),
        link=LinkOptions(num_classes=args.num_classes),
        perturb=perturb_opts,
        stages=tuple(args.stages.split(",")),
    )


def main(argv=None, frames=None) -> int:
    """The tool; ``frames`` optionally maps a video's name to its uint8 frames
    at ``--image_hw`` (the sweeps' in-memory frames: no JPEG decode)."""
    args = parse_args(argv)

    import torch

    from vdetlib_tpu_torch.dist.multihost import init_multihost, process_video_shard
    from vdetlib_tpu_torch.dist.sharding import shard_videos
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.pipeline.checkpoint import load_params
    from vdetlib_tpu_torch.pipeline.fused_runner import run_videos_fused
    from vdetlib_tpu_torch.pipeline.runner import Models, run_videos
    from vdetlib_tpu_torch.protos import proto_load
    from vdetlib_tpu_torch.utils.log import get_logger
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    vid_files = sorted(glob.glob(os.path.join(args.data_dir, "*.vid.json")))
    if args.multihost:
        init_multihost(device=args.device)
        vid_files = process_video_shard(vid_files)
    else:
        vid_files = shard_videos(vid_files, args.shard[0], args.shard[1])
    if not vid_files:
        raise SystemExit(f"no *.vid.json under {args.data_dir} for this shard")

    cfg = pipeline_config(args)
    det_model = init_detector(detector_preset(args.model, num_classes=args.num_classes),
                              torch.Generator().manual_seed(args.seed), device=args.device)
    if args.detector_weights:
        load_params(args.detector_weights, det_model)
    trk_model = init_tracker(cfg.tracker_cfg, torch.Generator().manual_seed(args.seed + 1),
                             device=args.device)
    if args.tracker_weights:
        load_params(args.tracker_weights, trk_model)
    models = Models(det_model, trk_model)

    frames = frames or {}
    inputs = []
    for vf in vid_files:
        bf = vf.replace(".vid.json", ".box.json")
        vid = proto_load(vf)
        entry = (vid, proto_load(bf) if os.path.exists(bf) else None)
        inputs.append(entry + ((frames[vid["video"]],) if vid["video"] in frames else ()))
    if args.engine == "fused":
        results = run_videos_fused(args.workdir, inputs, models, cfg,
                                   group_size=args.fused_group, keep_going=args.keep_going)
    else:
        results = run_videos(args.workdir, inputs, models, cfg, workers=args.staged_workers,
                             keep_going=args.keep_going, device=args.device)
    failed = [r for r in results if r.get("error")]
    if failed:
        get_logger("pipeline").warning("%d/%d videos failed: %s", len(failed), len(results),
                                       ", ".join(r["video"] for r in failed))

    if args.eval:
        from vdetlib_tpu_torch.evaluation.calibration import rank_normalize
        from vdetlib_tpu_torch.evaluation.vid_map import vid_map

        eval_pairs = [(vf, r["result"]) for vf, r in zip(vid_files, results)]
        if args.multihost:
            import torch.distributed as dist

            from vdetlib_tpu_torch.dist.multihost import allreduce_metrics

            # barrier: every process has written its shard's protos
            allreduce_metrics({"shards_done": 1.0})
            if dist.is_initialized() and dist.get_rank() != 0:
                return 0
            # rank 0 evaluates over every shard's outputs (shared workdir)
            eval_pairs = []
            for vf in sorted(glob.glob(os.path.join(args.data_dir, "*.vid.json"))):
                video = os.path.basename(vf)[: -len(".vid.json")]
                eval_pairs.append((vf, os.path.join(args.workdir, video, "final.json")))
        pairs = []
        for vf, rf in eval_pairs:
            af = vf.replace(".vid.json", ".annot.json")
            if os.path.exists(af) and os.path.exists(rf):  # absent = failed video
                dp = proto_load(rf)
                if args.calibrate == "rank":
                    dp = rank_normalize(dp, blend=args.calibrate_blend)
                pairs.append((dp, proto_load(af)))
        m, aps = vid_map(pairs)
        for ci in sorted(aps):
            print(f"class {ci}: AP = {aps[ci]:.4f}")
        print(f"mAP = {m:.4f} over {len(pairs)} videos")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
