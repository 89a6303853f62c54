#!/usr/bin/env python
"""Where the port's tiny float32 stream on a CUDA card departs from the same
stream on the CPU, and how far a last-bit change alone carries it.

    python scripts/torch_stream_divergence.py [--frames 20] [--device cuda|cpu]

The run is ``chip_smoke.py``'s tiny stream (tiny detector, C=4, seeded
float32 weights, 96×128 frames, chunk 8, 16 proposals, 6 track slots). Two
experiments, each with the tracker's search-window pooling in bfloat16 (as
the port runs it) and in float32:

1. sensitivity, on the CPU: the stream against itself with the tracker
   features multiplied by (1 + u), |u| <= 2^-22 (a few float32 ulps, the size
   of a summation-order change), in four seeded draws: the largest
   track-box change per frame;
2. card against CPU (``--device cuda``): per chunk and per stage, the
   detector's class probabilities (max |diff|), the tracker features (max
   |diff| over max |value|), the NMS keep bits and the seeds (equal or not),
   the forward track boxes per frame and the backward re-tracked boxes
   (max |diff| in px over live lanes); then the largest track-box difference
   per frame of the whole run.

Nothing is asserted: the script prints what it measured.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import vdetlib_tpu_torch.video.stream as st  # noqa: E402
import vdetlib_tpu_torch.kernels.track_scan as tr  # noqa: E402  (the search-window pooling)


def run(dev, frames, rois, noise=0.0, draw=0, f32_pool=False):
    """The tiny stream on ``dev``; returns (result, per-chunk records)."""
    recs = []
    detect, feats_fn, make_fn, pool = (st._detect_step, st.tracker_features,
                                       st.make_stream_chunk_fn, tr.roi_align)

    def rec_detect(*a):
        probs, boxes = detect(*a)
        recs.append({"probs": probs.float().cpu().numpy()})
        return probs, boxes

    def rec_feats(model, f):
        x = feats_fn(model, f)
        if noise:
            g = torch.Generator().manual_seed(1000 * draw + len(recs))
            u = (torch.rand(x.shape, generator=g) * 2 - 1) * noise
            x = x * (1 + u.to(x.device))
        recs[-1]["feats"] = x.float().cpu().numpy()
        return x

    def rec_make(*a):
        step, unpack = make_fn(*a)

        def rec_unpack(flat):
            out = unpack(flat)
            recs[-1].update(out)
            return out
        return step, rec_unpack

    st._detect_step, st.tracker_features, st.make_stream_chunk_fn = (
        rec_detect, rec_feats, rec_make)
    if f32_pool:
        tr.roi_align = lambda *a, **k: pool(*a, **{**k, "compute_dtype": None})
    try:
        res = cs.tiny_stream(dev, frames, rois)
    finally:
        st._detect_step, st.tracker_features, st.make_stream_chunk_fn = (
            detect, feats_fn, make_fn)
        tr.roi_align = pool
    return res, recs


def track_diff_per_frame(got, want, T):
    """Largest track-box |diff| (px) per frame over tracks on the same frames;
    the tracks whose frames differ are listed apart."""
    per_t = np.zeros(T)
    differ = []
    for tid, wseg in want["tracks"].items():
        gseg = got["tracks"].get(tid)
        if gseg is None or [t for t, _, _ in gseg] != [t for t, _, _ in wseg]:
            differ.append(tid)
            continue
        for (t, gb, _), (_, wb, _) in zip(gseg, wseg):
            per_t[t] = max(per_t[t], float(np.abs(np.asarray(gb) - np.asarray(wb)).max()))
    return per_t, differ


def fmt(xs):
    return "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"


def stages(got, want):
    """Per chunk, per stage: card (``got``) against CPU (``want``)."""
    for k, (g, w) in enumerate(zip(got, want)):
        probs = float(np.abs(g["probs"] - w["probs"]).max())
        feats = float(np.abs(g["feats"] - w["feats"]).max() / np.abs(w["feats"]).max())
        keep = np.array_equal(g["out_keep"] > 0.5, w["out_keep"] > 0.5)
        seeds = all(np.array_equal(g[n], w[n]) for n in ("seed_ok", "seed_slot", "seed_ti"))
        live = w["ta"] > 0.5
        tb = np.where(live[..., None], np.abs(g["tb"] - w["tb"]), 0.0).max(axis=(0, 2))
        blive = w["balive"] > 0.5
        bb = np.where(blive[..., None], np.abs(g["bb"] - w["bb"]), 0.0).max(axis=(0, 2))
        print(f"  chunk {k}: det probs {probs:.2e}; tracker feats (relative) {feats:.2e}; "
              f"keep bits {'equal' if keep else 'DIFFER'}; seeds {'equal' if seeds else 'DIFFER'}"
              f"; live carried slots {int(live.any(1).sum())}, fresh seeds "
              f"{int((w['seed_ok'] > 0.5).sum())}")
        print(f"    forward track boxes per frame (px): {fmt(tb)}")
        print(f"    backward re-tracked boxes per window frame (px): {fmt(bb)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device: pass --device cpu for the sensitivity experiment alone")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {cs.gpu_name_and_power()}")
    T = args.frames
    frames, rois, _ = cs.tiny_inputs(seed=8, T=T)
    for f32_pool in (False, True):
        pool = "float32" if f32_pool else "bfloat16 (as shipped)"
        print(f"== search-window pooling in {pool}, {T} frames")
        base, base_recs = run("cpu", frames, rois, f32_pool=f32_pool)
        for draw in range(4):
            pert, _ = run("cpu", frames, rois, noise=2.0 ** -22, draw=draw, f32_pool=f32_pool)
            per_t, differ = track_diff_per_frame(pert, base, T)
            print(f"CPU vs CPU with tracker features x (1 + u), |u| <= 2^-22, draw {draw}: "
                  f"track boxes per frame (px) {fmt(per_t)}; max {per_t.max():.4f}; tracks on "
                  f"other frames {differ}")
        if args.device == "cuda":
            card, card_recs = run(torch.device("cuda", 0), frames, rois, f32_pool=f32_pool)
            print("card vs CPU, per chunk:")
            stages(card_recs, base_recs)
            per_t, differ = track_diff_per_frame(card, base, T)
            first = int(np.argmax(per_t > 1e-3)) if (per_t > 1e-3).any() else None
            print(f"card vs CPU: track boxes per frame (px) {fmt(per_t)}; max "
                  f"{per_t.max():.4f}; first frame above 1e-3 px: {first}; tracks on other "
                  f"frames {differ}")


if __name__ == "__main__":
    main()
