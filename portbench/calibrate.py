"""Readings that a cell's correctness limits are set from: for each seed, the
program's numbers against the plain reference, and the control's (the
reference one number format down in every stage, put in the program's
place) against the same reference.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--fault]

A seed's videos are the ones a run of the cell checks when it has finished
the whole queue: the longest, and others drawn from the seed. The program
processes them through the timed path's own entry (``run_videos_fused`` or
``stream_video``). For the stream's tracker steps the control recomputes
the same program states in the lower formats. With ``--fault`` the sweep's
program also runs with its tracker frozen (:func:`frozen_tracks`), and those
numbers are given as ``fault``; the sweep's tracker steps, like the stream's,
are recomputed from the program's recorded tracks. One JSON line per seed.
Needs a CUDA card, as the benchmark does; the CPU tests call :func:`readings`
on the tiny preset.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def frozen_tracks(real):
    """The fused engine's ``track_batch`` with every step returning its state
    unchanged: each track keeps its anchor's box at every frame."""

    def frozen(trk_cfg, feats, anchor_t, anchor_boxes, *a, **k):
        tb, tc, ta = real(trk_cfg, feats, anchor_t, anchor_boxes, *a, **k)
        return anchor_boxes[:, None, :].expand_as(tb).contiguous(), tc, ta
    return frozen


def _sweep(cell, seed, device, work, fault=False):
    from unittest import mock

    import torch

    import vdetlib_tpu_torch.pipeline.fused as pf
    from portbench.engines import fused_sweep as fs
    from portbench.harness import compare, videos
    from portbench.harness.models import program_models, reference_models
    from portbench.reference.stream import track_steps, video_features
    from vdetlib_tpu_torch.pipeline.fused_runner import run_videos_fused
    from vdetlib_tpu_torch.pipeline.runner import Models

    config, mix = cell.config, cell.traffic
    f = config["fused"]
    det, trk, _, ds, ts = program_models(config, seed, device)
    cfg = fs.serve_pipeline_config(config)
    pool = fs.make_queue(config, mix, seed, device)
    chosen = fs.pick_checked([(f"c{i}", i) for i in range(len(pool))], pool,
                             mix["check_videos"], seed)
    boxes = {i: videos.box_proto("queue", pool[i][1]) for _, i in chosen}
    queue = [(videos.vid_proto(n, pool[i][0].shape[0]), boxes[i], pool[i][0]) for n, i in chosen]
    sides = ["program"] + (["fault"] if fault else [])
    tracks = {side: {} for side in sides}
    with fs.recorded_tracks(tracks["program"]):
        run_videos_fused(os.path.join(work, "program"), queue, Models(det, trk), cfg)
    if fault:
        with fs.recorded_tracks(tracks["fault"]), \
                mock.patch.object(pf, "track_batch", frozen_tracks(pf.track_batch)):
            run_videos_fused(os.path.join(work, "fault"), queue, Models(det, trk), cfg)
    del det, trk
    out = {side: {} for side in sides + ["control"]}
    min_score = cfg.link.min_score

    def add(side, nums):
        for k, v in nums.items():
            out[side][k] = out[side].get(k, 0) + v if k in ("final_dets", "tracks") else \
                max(out[side].get(k, 0), v)

    nominal = reference_models(config, ds, ts, device)
    lower = reference_models(config, ds, ts, device, lower=True)
    for n, i in chosen:
        frames, rois = pool[i]
        for side in sides:
            add(side, fs.check_video(*nominal, config, frames, rois,
                                     os.path.join(work, side, n, "final.json"),
                                     tracks[side][n], min_score))
        # the control in the program's place: its final detections against the
        # reference run on the control's own tracks, and the program's
        # tracker steps recomputed one format down
        ctl = fs.reference_video(*lower, config, frames, rois)
        tb, ta = (torch.from_numpy(ctl[k]) for k in ("track_boxes", "track_alive"))
        ref = fs.reference_video(*nominal, config, frames, rois, (tb, None, ta))
        add("control", fs.check_numbers(compare.array_entries(ctl, min_score), ref, config,
                                        min_score))
        t_valid = tracks["program"][n][4]
        add("control", compare.anchor_gap(ctl["track_boxes"], ctl["track_conf"],
                                          int(ctl["track_alive"].any(-1).sum()), t_valid,
                                          ref["cand_boxes"], ref["cand_mask"]))
        b, c, a, k, _ = tracks["program"][n]
        st = compare.fused_track_steps(b.cpu().numpy(), c.cpu().numpy(), a.cpu().numpy(),
                                       int(k), t_valid, f["track_stride"])
        steps_in = [x[:4] for x in st]
        nb, npk = track_steps(nominal[1], video_features(
            nominal[1], frames[:t_valid:f["track_stride"]], f["feat_batch"]), steps_in)
        lb, lpk = track_steps(lower[1], video_features(
            lower[1], frames[:t_valid:f["track_stride"]], f["feat_batch"]), steps_in)
        ctl_steps = [x[:4] + ((lb[j], lpk[j]) if x[4] is not None else (None, None))
                     for j, x in enumerate(st)]
        add("control", compare.track_steps(ctl_steps, nb, npk, f["track_conf"]))
    return out


def _stream(cell, seed, device):
    from portbench.engines import fused_sweep as fs
    from portbench.engines import stream as st
    from portbench.harness import compare
    from portbench.harness.models import program_models, reference_models
    from portbench.reference.stream import stream_emissions, track_steps, video_features

    config, mix = cell.config, cell.traffic
    det, trk, trk_cfg, ds, ts = program_models(config, seed, device)
    opts = st.stream_options(config)
    pool = fs.make_queue(config, mix, seed, device)
    chosen = fs.pick_checked([(f"c{i}", i) for i in range(len(pool))], pool,
                             mix["check_videos"], seed)
    results = {i: st.stream_one(det, trk, trk_cfg, opts, *pool[i])[0] for _, i in chosen}
    del det, trk
    sopts = types.SimpleNamespace(**config["stream"])
    chk = config["check"]
    nominal = reference_models(config, ds, ts, device)
    lower = reference_models(config, ds, ts, device, lower=True)
    out = {"program": {}, "control": {}}

    def worst(side, nums):
        for k, v in nums.items():
            out[side][k] = max(out[side].get(k, 0.0), v)

    for _, i in chosen:
        frames, rois = pool[i]
        res = results[i]
        ref = stream_emissions(nominal[0], sopts, frames, rois)
        ctl = stream_emissions(lower[0], sopts, frames, rois)
        steps = compare.stream_track_steps(res["tracks"], frames.shape[0], sopts.chunk)
        nf = video_features(nominal[1], frames, config["feat_batch"])
        lf = video_features(lower[1], frames, config["feat_batch"])
        nb, npk = track_steps(nominal[1], nf, [s[:4] for s in steps])
        lb, lpk = track_steps(lower[1], lf, [s[:4] for s in steps])
        prog = compare.emissions(res, ref, chk["box_px"], chk["score"])
        prog.update(compare.track_steps(steps, nb, npk, sopts.conf_thresh))
        prog.update(compare.seeds(res["tracks"], res, sopts.seed_thresh))
        # the control's steps in the program's place: its boxes and peaks as recorded
        ctl_steps = [s[:4] + ((lb[j], None if s[5] is None else lpk[j]) if s[4] is not None
                              else (None, None)) for j, s in enumerate(steps)]
        ctl_nums = compare.emissions(ctl, ref, chk["box_px"], chk["score"])
        ctl_nums.update(compare.track_steps(ctl_steps, nb, npk, sopts.conf_thresh))
        worst("program", prog)
        worst("control", ctl_nums)
    return out


def readings(cell, seed: int, device, fault: bool = False) -> dict:
    """One seed's {"program": numbers, "control": numbers} for ``cell``, and
    the sweep's ``fault`` numbers with ``fault``."""
    if cell.config["engine"] == "fused_sweep":
        work = tempfile.mkdtemp(prefix="portbench_cal_", dir=os.environ.get("TMPDIR"))
        try:
            return _sweep(cell, seed, device, work, fault)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return _stream(cell, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", action="store_true", help="also the sweep with its tracker frozen")
    args = p.parse_args(argv)
    from portbench.harness import common

    cell = common.load_cell(args.workload)
    common.prepare_process()
    import torch

    if not torch.cuda.is_available():
        common.fail("calibration needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vdetlib_tpu_torch.kernels import build

    build.build_all()
    for seed in args.seeds:
        out = readings(cell, seed, torch.device("cuda", 0), args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
