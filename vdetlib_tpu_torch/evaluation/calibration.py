"""Cross-video score calibration — the port's copy of ``rank_normalize`` (and
its helper ``_det_score_items``) from ``vdetlib_tpu/evaluation/calibration.py``.

Per-video score distributions differ (object count, track length, rescoring
boosts), so a pooled ranking across videos interleaves them wrongly even
when every per-video ranking is right. ``rank_normalize`` replaces each
video's per-class scores by their within-video rank quantile (label-free).
The Platt calibrator and the ``calibrate`` tool are not ported yet
(ROADMAP.md, Queue 1: evaluation and the remaining host tools).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ["rank_normalize"]


def _det_score_items(det_proto: dict):
    """Yield (det_entry, score_entry) pairs."""
    for d in det_proto.get("detections", []):
        for s in d.get("scores", []):
            yield d, s


def rank_normalize(det_proto: dict, blend: float = 0.0) -> dict:
    """Per-video per-class quantile transform (label-free).

    new_score = (1-blend) · quantile_rank + blend · raw_score. With blend=0
    every video's per-class scores map uniformly onto (0, 1]: within-video
    ordering is kept exactly, and pooled ranking no longer depends on each
    video's private score scale. A video holding only junk detections gets
    them promoted too; raise ``blend`` to keep some raw cross-video evidence.
    """
    by_class = defaultdict(list)
    for _, s in _det_score_items(det_proto):
        by_class[int(s["class_index"])].append(float(s["score"]))
    ranks = {ci: np.sort(np.asarray(v)) for ci, v in by_class.items()}
    out = {k: v for k, v in det_proto.items() if k != "detections"}
    out["detections"] = []
    for d in det_proto.get("detections", []):
        nd = dict(d)
        nd["scores"] = []
        for s in d["scores"]:
            arr = ranks[int(s["class_index"])]
            raw = float(s["score"])
            q = np.searchsorted(arr, raw, side="right") / len(arr)
            ns = dict(s)
            ns["score"] = float((1.0 - blend) * q + blend * raw)
            nd["scores"].append(ns)
        out["detections"].append(nd)
    return out
