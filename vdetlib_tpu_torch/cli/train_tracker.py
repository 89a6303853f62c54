"""Train the correlation tracker on synthetic motion; save a checkpoint of the port.

Counterpart of ``python -m vdetlib_tpu train_tracker``, with the same flags
plus ``--device`` (default ``cuda``; ``--device cpu`` trains on the CPU).
The output is one ``save_params`` file (``pipeline/checkpoint.py``), which
the ``--tracker_weights`` / ``--weights`` flags of ``track``, ``stream`` and
``pipeline`` load.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output", help="checkpoint file (pipeline/checkpoint.py format)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--image_hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--num_videos", type=int, default=8)
    p.add_argument("--frames_per_video", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tier", default="easy", choices=["easy", "hard"],
                   help="hard: train on the hard-tier distribution "
                   "(occlusion/distractors/camera motion)")
    p.add_argument("--scale_rate", type=float, default=0.0,
                   help="per-frame object zoom in the training videos "
                   "(match gen_synth --scale_rate for zooming-object evals)")
    p.add_argument("--recipe", default="pair", choices=["pair", "aware"],
                   help="aware: occlusion/distractor-aware sampler + "
                   "distractor-hinge + occlusion-suppression loss "
                   "(nn/tracker_train.py::tracker_loss_aware)")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)

    import torch

    from vdetlib_tpu_torch import weights
    from vdetlib_tpu_torch.data.synth import SynthConfig, hard_config, make_video
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.nn.tracker_train import train_tracker
    from vdetlib_tpu_torch.pipeline.checkpoint import save_params

    h, w = args.image_hw
    cfg = TrackerConfig()
    model = weights.init_tracker(cfg, torch.Generator().manual_seed(args.seed),
                                 device=args.device)

    def synth_cfg(seed):
        common = dict(num_frames=args.frames_per_video, height=h, width=w, seed=seed,
                      scale_rate=args.scale_rate)
        if args.tier == "hard":
            return hard_config(**common)
        return SynthConfig(**common)

    videos = [make_video(synth_cfg(args.seed + i)) for i in range(args.num_videos)]
    train_tracker(model, cfg, videos, steps=args.steps, batch_size=args.batch_size, lr=args.lr,
                  seed=args.seed, recipe=args.recipe)
    save_params(args.output, model)
    print(f"saved tracker weights to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
