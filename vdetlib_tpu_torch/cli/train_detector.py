"""Train the detector on synthetic videos and save a checkpoint of the port.

Counterpart of ``python -m vdetlib_tpu train_detector``, with the same flags
plus ``--device`` (default ``cuda``; ``--device cpu`` trains on the CPU).
The recipe is the JAX tool's: class-coded appearance, photometric + flip
augmentation, AdamW with a global-norm clip (``--lr_schedule cosine`` for
longer runs), and a held-out mAP@0.5 every ``--eval_every`` steps whose
best step is the one saved. The held-out eval runs per-class NMS with
``batched_nms`` on (frames, classes, ``--max_rois``) problems: kernel C on
the card at up to 128 proposals. The output is one ``save_params`` file
(``pipeline/checkpoint.py``), which the ``--weights`` flags of ``detect``,
``stream`` and ``pipeline`` load.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass


@dataclass
class BatchOptions:
    batch_size: int
    max_rois: int
    augment: bool


def heldout_problems(model, sv, max_rois: int):
    """One held-out video's per-class NMS problems on the model's device:
    boxes (T, K, R, 4), scores (T, K, R) and valid (T, K, R), the detector's
    regressed boxes and probabilities for its ``box_proto`` proposals."""
    import numpy as np
    import torch

    from vdetlib_tpu_torch.data.synth import box_proto
    from vdetlib_tpu_torch.protos.arrays import box_proto_to_arrays
    from vdetlib_tpu_torch.video.detect import DetectOptions, detect_arrays

    rois, roi_mask = box_proto_to_arrays(box_proto(sv), sv.frame_ids, max_rois)
    probs, boxes = detect_arrays(model, sv.frames, rois, roi_mask,
                                 DetectOptions(max_rois=max_rois))
    cls_scores = np.transpose(probs, (0, 2, 1))  # (T, K, R)
    cls_boxes = np.transpose(boxes, (0, 2, 1, 3))  # (T, K, R, 4)
    valid = (cls_scores > 0.01) & roi_mask[:, None, :]
    dev = next(model.parameters()).device
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (cls_boxes, cls_scores, valid))


def evaluate_heldout_map(model, videos, num_classes, max_rois, nms_thresh=0.3):
    """Detection mAP@0.5 on held-out SynthVideos (in memory, no disk).

    Proposals are each video's box_proto (jittered GT + distractors); the
    detector scores them; per-class NMS; greedy-matched VOC AP. Returns
    (mAP, per-class AP)."""
    import numpy as np

    from vdetlib_tpu_torch.data.synth import annot_proto
    from vdetlib_tpu_torch.evaluation.vid_map import vid_map
    from vdetlib_tpu_torch.kernels.nms import batched_nms
    from vdetlib_tpu_torch.protos.arrays import arrays_to_det_proto

    pairs = []
    for sv in videos:
        boxes, scores, valid = heldout_problems(model, sv, max_rois)
        keep = batched_nms(boxes, scores, valid, nms_thresh)
        cls_boxes = boxes.cpu().numpy()
        cls_scores = scores.cpu().numpy()
        kept_scores = np.where((keep & valid).cpu().numpy(), cls_scores, 0.0)
        K = cls_scores.shape[1]
        det = {"video": sv.video, "detections": []}
        for c in range(1, K):
            sub = arrays_to_det_proto(
                cls_boxes[:, c],
                np.eye(K, dtype=np.float32)[None, None, c] * kept_scores[:, c, :, None],
                kept_scores[:, c] > 0,
                sv.frame_ids, sv.video, score_thresh=0.01,
            )
            det["detections"].extend(sub["detections"])
        pairs.append((det, annot_proto(sv)))
    return vid_map(pairs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output", help="checkpoint file (pipeline/checkpoint.py format)")
    p.add_argument("--model", default="tiny", choices=["base", "small", "tiny"])
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_rois", type=int, default=64)
    p.add_argument("--image_hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_schedule", default="const", choices=["const", "cosine"],
                   help="cosine: 5%% warmup then cosine decay to lr/100 over "
                   "--steps (for longer-schedule recipes)")
    p.add_argument("--num_videos", type=int, default=8)
    p.add_argument("--frames_per_video", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--eval_every", type=int, default=100,
                   help="held-out mAP eval period; 0 disables")
    p.add_argument("--eval_videos", type=int, default=4)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--no_class_coded", action="store_true",
                   help="legacy round-1 data: appearance independent of class")
    p.add_argument("--tier", default="easy", choices=["easy", "hard"],
                   help="hard: train on the hard-tier distribution "
                   "(occlusion/distractors/camera motion — gen_synth --tier)")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)

    import time

    import numpy as np
    import torch

    from vdetlib_tpu_torch import weights
    from vdetlib_tpu_torch.data.synth import SynthConfig, hard_config, make_video
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.train import (
        init_train_state,
        make_optimizer,
        make_training_batch,
        train_step,
    )
    from vdetlib_tpu_torch.pipeline.checkpoint import save_params
    from vdetlib_tpu_torch.utils.log import get_logger

    log = get_logger("train_detector")
    dev = torch.device(args.device)
    h, w = args.image_hw
    cfg = detector_preset(args.model, num_classes=args.num_classes)
    model = weights.init_detector(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    opt = make_optimizer(model.parameters(), args.lr, schedule=args.lr_schedule,
                         total_steps=args.steps)
    state = init_train_state(model, opt)

    def synth_cfg(seed):
        common = dict(num_frames=args.frames_per_video, height=h, width=w,
                      num_classes=args.num_classes, seed=seed)
        if args.tier == "hard":
            return hard_config(**common)
        return SynthConfig(class_coded_appearance=not args.no_class_coded, **common)

    videos = [make_video(synth_cfg(args.seed + i)) for i in range(args.num_videos)]
    # held-out videos live in a disjoint seed space
    heldout = [make_video(synth_cfg(args.seed + 10_000 + i)) for i in range(args.eval_videos)]

    opts = BatchOptions(args.batch_size, args.max_rois, not args.no_augment)
    rng = np.random.default_rng(args.seed)
    best_map, best_step, best_state = -1.0, -1, None
    batch_s = eval_s = 0.0
    t_run = time.perf_counter()
    for step in range(args.steps):
        t0 = time.perf_counter()
        model.train()
        sv = videos[int(rng.integers(0, len(videos)))]
        batch = make_training_batch(sv, rng, opts, args.num_classes)
        batch_s += time.perf_counter() - t0
        aux = train_step(model, opt, batch)
        state.step += 1
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %d loss=%.4f cls=%.4f reg=%.4f", step, float(aux["loss"]),
                     float(aux["cls_loss"]), float(aux["reg_loss"]))
        last = step == args.steps - 1
        if args.eval_every and ((step + 1) % args.eval_every == 0 or last):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            model.eval()
            m, per_class = evaluate_heldout_map(model, heldout, args.num_classes, args.max_rois)
            eval_s += time.perf_counter() - t0
            log.info("step %d held-out mAP@0.5 = %.4f (per-class %s)", step, m,
                     {k: round(v, 3) for k, v in sorted(per_class.items())})
            if m > best_map:
                best_map, best_step = m, step
                best_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t_run

    if best_state is not None:
        log.info("saving best checkpoint: step %d mAP %.4f", best_step, best_map)
        save_params(args.output, best_state)
    else:
        save_params(args.output, model)
    n = max(state.step, 1)
    print(f"trained {state.step} steps on {dev}: {(run_s - eval_s) * 1e3 / n:.1f} ms a step "
          f"({batch_s * 1e3 / n:.1f} of it building the batch on the host), eval {eval_s:.1f} s, "
          f"run {run_s:.1f} s; best held-out mAP@0.5 {best_map:.4f} at step {best_step}")
    print(f"saved weights to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
