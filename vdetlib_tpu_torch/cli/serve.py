"""Serving daemon: watch a directory for new videos and process them continuously.

Counterpart of ``python -m vdetlib_tpu serve``, with the same flags and
defaults plus ``--device`` (default ``cuda``; the daemon raises before it
reads the queue when there is no card, unless ``--device cpu`` is given).
It polls ``<data_dir>`` for ``NAME.vid.json`` (+ optional ``NAME.box.json``)
whose ``<workdir>/NAME/final.json`` does not exist yet, runs each through
the staged engine (``pipeline/runner.py::run_video``) or the fused engine
(``pipeline/fused_runner.py::FusedEngine``), and writes the results under
``<workdir>/NAME/``. Several instances may share one queue, even on several
hosts over a shared filesystem: outputs are written atomically and a
per-video ``.lock`` directory gives mutual exclusion (:func:`try_lock`);
a crash resumes at the last completed stage.

With ``--engine fused`` a video without ``NAME.box.json`` goes to the
staged engine, and a fused failure is retried on the staged engine. A video
that fails on both engines is quarantined (``<workdir>/NAME/quarantine.json``,
skipped until an operator deletes it), and the daemon lives on.

**The one departure from JAX's daemon.** A kernel that cannot be built or
launched (``kernels/build.py::KernelError``) and a CUDA fault
(``torch.AcceleratorError``) are never retried on the staged engine and
never quarantined: the lock is released and the error leaves the daemon,
which exits non-zero. JAX's handlers catch every ``Exception``; in the port
that would serve every video on the staged engine, which never launches
kernel B, if B failed, or quarantine the whole queue if every kernel did,
and exit 0 either way.

The parts are functions of their own, so that tests and the card's smoke
run can drive each: :func:`serve_config` (the ``PipelineConfig``),
:func:`build_models` and :func:`serve_loop`. ``serve_loop``'s ``frames``
maps a video's name to its uint8 frames at ``image_hw`` (proposals in those
pixels), served from memory instead of the JPEG files; the CLI does not
expose it (the card's machine has no ``cv2``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import socket
import time


def try_lock(lock: str, ttl_sec: float = 3600.0) -> bool:
    """Acquire a per-video lock directory; reclaim crashed owners.

    A lock carries an ``owner.json`` (host, pid, timestamp). It is considered
    STALE — and reclaimed — when its owner process is dead (same host) or the
    lock is older than ``ttl_sec`` (any host; covers SIGKILL/OOM where the
    finally-block cleanup never ran). Reclaiming re-races through
    ``os.makedirs``, so exactly one contender wins.
    """
    meta = os.path.join(lock, "owner.json")
    try:
        os.makedirs(lock)  # atomic mutual exclusion
    except FileExistsError:
        stale = False
        try:
            with open(meta, "r", encoding="utf-8") as f:
                info = json.load(f)
            age = time.time() - float(info.get("time", 0))
            if age > ttl_sec:
                stale = True
            elif info.get("host") == socket.gethostname():
                try:
                    os.kill(int(info["pid"]), 0)
                except (OSError, ValueError):
                    stale = True  # owner process is gone
        except (OSError, ValueError):
            # no/corrupt metadata (owner crashed before writing): age the dir
            try:
                stale = time.time() - os.path.getmtime(lock) > ttl_sec
            except OSError:
                return False
        if not stale:
            return False
        shutil.rmtree(lock, ignore_errors=True)
        try:
            os.makedirs(lock)
        except FileExistsError:
            return False  # lost the reclaim race
    with open(meta, "w", encoding="utf-8") as f:
        json.dump(
            {"host": socket.gethostname(), "pid": os.getpid(), "time": time.time()},
            f,
        )
    return True


def parse_args(argv=None) -> argparse.Namespace:
    """The daemon's flags: JAX's, with its defaults, plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_dir")
    p.add_argument("workdir")
    p.add_argument("--detector_weights", default=None)
    p.add_argument("--tracker_weights", default=None)
    p.add_argument("--model", default="tiny",
                   choices=["base", "small", "tiny", "rfcn_r101", "rfcn_tiny"])
    p.add_argument("--num_classes", type=int, default=31)
    p.add_argument("--image_hw", type=int, nargs=2, default=[240, 320])
    p.add_argument("--max_rois", type=int, default=64)
    p.add_argument("--poll_sec", type=float, default=2.0)
    p.add_argument("--engine", default="staged", choices=["staged", "fused"],
                   help="staged = per-stage protos (per-stage crash resume); fused = the "
                        "fused pipeline per video (requires box protos — videos without "
                        "proposals fall back to the staged engine)")
    p.add_argument("--once", action="store_true", help="drain the queue and exit")
    p.add_argument("--lock_ttl_sec", type=float, default=3600.0,
                   help="reclaim locks older than this (crashed owners)")
    p.add_argument("--seed", type=int, default=0)
    # quality knobs: the pipeline tool's, with the same semantics
    p.add_argument("--template_eta", type=float, default=0.0,
                   help="EMA template adaptation rate (confidence-gated; 0 = frozen anchor "
                        "template)")
    p.add_argument("--track_scales", type=int, default=1,
                   help="tracker scale-search candidates (1 = off)")
    p.add_argument("--boost", choices=["max", "mean"], default="max",
                   help="rescore boost statistic application")
    p.add_argument("--bg_decay", type=float, default=1.0,
                   help="score multiplier for dets on no tubelet")
    p.add_argument("--top_ratio", type=float, default=0.5,
                   help="tubelet statistic = mean of top this-fraction scores")
    p.add_argument("--min_matched_frac", type=float, default=0.0,
                   help="track-quality gate (see pipeline tool)")
    p.add_argument("--snap_weight", type=float, default=0.0,
                   help="detection snapping weight (see pipeline tool)")
    p.add_argument("--snap_iou", type=float, default=0.5,
                   help="min IoU for detection snapping")
    p.add_argument("--stat_floor", type=int, default=0,
                   help="length prior on the tubelet statistic (frames)")
    p.add_argument("--tubelet_boxes", action="store_true",
                   help="inject interior-gap track boxes as detections")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda by default; cpu runs the kernels' "
                        "plain versions)")
    return p.parse_args(argv)


def _tracker_config(args):
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig

    return TrackerConfig(num_scales=args.track_scales, template_eta=args.template_eta)


def serve_config(args):
    """The ``PipelineConfig`` of JAX's daemon for ``args``: the stage defaults
    with ``DetectOptions(max_rois, image_hw, score_thresh=0.05)``, the
    quality knobs, and no perturbation stage (not the pipeline tool's)."""
    from vdetlib_tpu_torch.pipeline.runner import PipelineConfig
    from vdetlib_tpu_torch.video.detect import DetectOptions
    from vdetlib_tpu_torch.video.link import LinkOptions
    from vdetlib_tpu_torch.video.mgp import MGPOptions
    from vdetlib_tpu_torch.video.rescore import RescoreOptions
    from vdetlib_tpu_torch.video.track import TrackOptions

    hw = tuple(args.image_hw)
    return PipelineConfig(
        detect=DetectOptions(max_rois=args.max_rois, image_hw=hw, score_thresh=0.05),
        mgp=MGPOptions(num_classes=args.num_classes, image_hw=hw),
        track=TrackOptions(image_hw=hw, snap_weight=args.snap_weight, snap_iou=args.snap_iou),
        tracker_cfg=_tracker_config(args),
        rescore=RescoreOptions(num_classes=args.num_classes, boost=args.boost,
                               bg_decay=args.bg_decay, top_ratio=args.top_ratio,
                               min_matched_frac=args.min_matched_frac,
                               stat_floor=args.stat_floor, tubelet_boxes=args.tubelet_boxes),
        link=LinkOptions(num_classes=args.num_classes),
    )


def build_models(args, device):
    """The detector and tracker on ``device``: seeded random weights (the
    tracker's seed is ``args.seed + 1``, as the pipeline tool's), replaced by
    ``--detector_weights`` / ``--tracker_weights`` where given."""
    import torch

    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.pipeline.checkpoint import load_params
    from vdetlib_tpu_torch.pipeline.runner import Models
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset(args.model, num_classes=args.num_classes),
                        torch.Generator().manual_seed(args.seed), device=device)
    if args.detector_weights:
        load_params(args.detector_weights, det)
    trk = init_tracker(_tracker_config(args), torch.Generator().manual_seed(args.seed + 1),
                       device=device)
    if args.tracker_weights:
        load_params(args.tracker_weights, trk)
    return Models(det, trk)


def require_device(device) -> None:
    """Raise unless ``device`` can run here: a CUDA device needs a card (the
    daemon never moves to the CPU by itself)."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"serve: no CUDA device for --device {device}; pass --device cpu "
                           f"to serve on the CPU")


def _fatal_errors() -> tuple:
    """What neither handler of the daemon catches: a kernel's own error and
    a CUDA fault (``torch.AcceleratorError`` where the installed torch has it)."""
    import torch

    from vdetlib_tpu_torch.kernels.build import KernelError

    acc = getattr(torch, "AcceleratorError", None)
    return (KernelError,) + ((acc,) if acc is not None else ())


def serve_loop(data_dir: str, workdir: str, models, cfg, *, engine: str = "staged",
               once: bool = False, poll_sec: float = 2.0, lock_ttl_sec: float = 3600.0,
               device="cuda", frames=None) -> list[dict]:
    """Serve the queue under ``data_dir`` into ``workdir`` (JAX's loop; see
    the module docstring). With ``once`` it returns when a pass over the
    queue does no work, else it polls every ``poll_sec`` seconds for ever.

    With ``once`` it returns one record per video it took: ``video``,
    ``engine`` ("fused", "staged" or "quarantined"), ``frames`` and
    ``seconds`` (from the lock to the last output written; on a card, after
    a synchronise)."""
    import torch

    from vdetlib_tpu_torch.pipeline.runner import run_video
    from vdetlib_tpu_torch.protos import proto_dump, proto_load
    from vdetlib_tpu_torch.utils.log import get_logger

    require_device(device)
    log = get_logger("serve")
    fatal = _fatal_errors()
    on_card = torch.device(device).type == "cuda"
    frames = frames or {}
    fused_engine = None
    if engine == "fused":
        from vdetlib_tpu_torch.pipeline.fused_runner import FusedEngine

        fused_engine = FusedEngine(models, cfg)
    elif engine != "staged":
        raise ValueError(f"unknown engine: {engine}")

    def staged(vid, box, fr):
        run_video(workdir, vid, box, models, cfg, frames=fr, device=device)

    os.makedirs(workdir, exist_ok=True)
    log.info("serving %s → %s (%s engine)", data_dir, workdir, engine)
    records = []
    while True:
        did_work = False
        for vf in sorted(glob.glob(os.path.join(data_dir, "*.vid.json"))):
            name = os.path.basename(vf).replace(".vid.json", "")
            done_marker = os.path.join(workdir, name, "final.json")
            quarantine = os.path.join(workdir, name, "quarantine.json")
            lock = os.path.join(workdir, name + ".lock")
            if os.path.exists(done_marker) or os.path.exists(quarantine):
                continue
            if not try_lock(lock, ttl_sec=lock_ttl_sec):
                continue
            t0 = time.perf_counter()
            rec = {"video": name, "engine": "staged", "frames": 0}
            try:
                vid = proto_load(vf)
                bf = vf.replace(".vid.json", ".box.json")
                box = proto_load(bf) if os.path.exists(bf) else None
                fr = frames.get(name)
                rec["frames"] = len(vid["frames"])
                log.info("processing %s (%d frames)", name, len(vid["frames"]))
                # Per-video errors must not kill the daemon, or a raising video
                # would be taken again after a restart: a crash loop on one bad
                # input. A fused failure falls back to the staged engine; a
                # video failing both is quarantined. Kernel errors and CUDA
                # faults are not per-video errors: they leave the daemon.
                tried_fused = fused_engine is not None and box is not None
                try:
                    if tried_fused:
                        loaded = fused_engine.load(vid, box, frames=fr)
                        det_proto, tubelets, _ = fused_engine.run(vid, loaded)
                        os.makedirs(os.path.dirname(done_marker), exist_ok=True)
                        proto_dump(tubelets, os.path.join(workdir, name, "tubelets.json"))
                        proto_dump(det_proto, done_marker)
                        rec["engine"] = "fused"
                    else:
                        if fused_engine is not None:
                            log.info("%s: no box proto — fused engine falls back to staged",
                                     name)
                        staged(vid, box, fr)
                except fatal:
                    raise
                except Exception as e:  # noqa: BLE001 — the daemon must survive
                    if not tried_fused or rec["engine"] == "fused":
                        raise
                    log.warning("%s: fused engine failed (%s: %s) — retrying staged",
                                name, type(e).__name__, e)
                    staged(vid, box, fr)
                log.info("done %s (engine=%s)", name, rec["engine"])
            except fatal:
                log.exception("%s: kernel or CUDA failure — the daemon stops", name)
                raise
            except Exception as e:  # noqa: BLE001
                log.exception("%s: failed on both engines — quarantined", name)
                os.makedirs(os.path.dirname(quarantine), exist_ok=True)
                with open(quarantine, "w", encoding="utf-8") as f:
                    json.dump({"video": name, "error": f"{type(e).__name__}: {e}",
                               "host": socket.gethostname(), "time": time.time()}, f)
                rec["engine"] = "quarantined"
            finally:
                shutil.rmtree(lock, ignore_errors=True)
            if on_card:
                torch.cuda.synchronize(device)
            rec["seconds"] = time.perf_counter() - t0
            if once:  # a daemon that polls for ever keeps no history
                records.append(rec)
            did_work = True  # the video left the queue
        if once and not did_work:
            log.info("queue drained: %d videos processed",
                     sum(r["engine"] != "quarantined" for r in records))
            return records
        if not did_work:
            time.sleep(poll_sec)


def main(argv=None) -> int:
    args = parse_args(argv)
    require_device(args.device)
    cfg = serve_config(args)
    models = build_models(args, args.device)
    serve_loop(args.data_dir, args.workdir, models, cfg, engine=args.engine, once=args.once,
               poll_sec=args.poll_sec, lock_ttl_sec=args.lock_ttl_sec, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
