"""Cross-video score calibration — the port's copy of
``vdetlib_tpu/evaluation/calibration.py``.

Per-video score distributions differ (object count, track length, rescoring
boosts), so a pooled ranking across videos interleaves them wrongly even
when every per-video ranking is right. Two strategies:

- ``rank_normalize``: label-free; each video's per-class scores are
  replaced by their within-video rank quantile.
- ``PlattCalibrator``: per-class logistic (Platt) scaling score → P(TP),
  fit on a labeled validation split (det/annot proto pairs, the greedy IoU
  matching of ``evaluation/vid_map.py``). Monotone per class, so every
  per-class AP is kept exactly: it makes scores comparable across classes
  and meaningful as thresholds (submission cutoffs), measured by the Brier
  score on held-out videos.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from vdetlib_tpu_torch.evaluation.vid_map import _gt_from_annot
from vdetlib_tpu_torch.utils.common import iou as iou_matrix

__all__ = ["PlattCalibrator", "brier_score", "calibrate_det_protos", "collect_tp_samples",
           "rank_normalize"]


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


def collect_tp_samples(pairs: Sequence[tuple[dict, dict]], iou_thresh: float = 0.5
                       ) -> dict[int, list[tuple[float, float]]]:
    """Label every score entry TP/FP by the eval protocol's greedy matching:
    {class_index: [(score, 1.0 if TP else 0.0), ...]} across videos."""
    samples = defaultdict(list)
    for det_proto, annot_proto in pairs:
        gt = _gt_from_annot(annot_proto)
        per_class = defaultdict(list)
        for d, s in _det_score_items(det_proto):
            per_class[int(s["class_index"])].append((float(s["score"]), int(d["frame"]),
                                                     d["bbox"]))
        for ci, dets in per_class.items():
            dets.sort(key=lambda r: -r[0])
            matched = {}  # frame -> used mask
            for score, frame, bbox in dets:
                boxes = gt.get((frame, ci))
                hit = False
                if boxes:
                    if frame not in matched:
                        matched[frame] = np.zeros(len(boxes), bool)
                    m = iou_matrix([bbox], boxes)[0]
                    for gi in np.argsort(-m):
                        if m[gi] < iou_thresh:
                            break
                        if not matched[frame][gi]:
                            matched[frame][gi] = True
                            hit = True
                            break
                samples[ci].append((score, 1.0 if hit else 0.0))
    return samples


def brier_score(pairs: Sequence[tuple[dict, dict]], iou_thresh: float = 0.5) -> float:
    """Mean squared error of scores as TP probabilities (lower = better)."""
    samples = collect_tp_samples(pairs, iou_thresh)
    vals = [(s - y) ** 2 for v in samples.values() for s, y in v]
    return float(np.mean(vals)) if vals else 0.0


@dataclass
class PlattCalibrator:
    """Per-class logistic calibration fit on labeled validation videos."""

    iou_thresh: float = 0.5
    min_samples: int = 20  # below this a class falls back to the global fit
    params: dict = field(default_factory=dict)  # ci -> (a, b)
    global_params: tuple = (1.0, 0.0)

    def fit(self, pairs: Sequence[tuple[dict, dict]]) -> "PlattCalibrator":
        """pairs: (det_proto, annot_proto) per validation video."""
        samples = collect_tp_samples(pairs, self.iou_thresh)
        all_samples = [xy for v in samples.values() for xy in v]
        self.global_params = _fit_platt(all_samples)
        for ci, v in samples.items():
            self.params[ci] = _fit_platt(v) if len(v) >= self.min_samples else self.global_params
        return self

    def transform(self, det_proto: dict) -> dict:
        out = {k: v for k, v in det_proto.items() if k != "detections"}
        out["detections"] = []
        for d in det_proto.get("detections", []):
            nd = dict(d)
            nd["scores"] = []
            for s in d["scores"]:
                a, b = self.params.get(int(s["class_index"]), self.global_params)
                ns = dict(s)
                ns["score"] = float(_sigmoid(a * float(s["score"]) + b))
                nd["scores"].append(ns)
            out["detections"].append(nd)
        return out

    def to_json(self) -> dict:
        return {
            "iou_thresh": self.iou_thresh,
            "global": list(self.global_params),
            "per_class": {str(k): list(v) for k, v in self.params.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlattCalibrator":
        c = cls(iou_thresh=d.get("iou_thresh", 0.5))
        c.global_params = tuple(d["global"])
        c.params = {int(k): tuple(v) for k, v in d["per_class"].items()}
        return c


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))


def _fit_platt(samples, iters: int = 200, lr: float = 1.0):
    """Newton-damped gradient fit of sigmoid(a·s + b) to (score, label).

    Platt's target smoothing (t+ = (N+ + 1)/(N+ + 2)) keeps small splits
    stable; ``a`` is clamped non-negative so the per-class mapping stays
    monotone (ranking-preserving)."""
    if not samples:
        return (1.0, 0.0)
    s = np.asarray([x for x, _ in samples], np.float64)
    y = np.asarray([t for _, t in samples], np.float64)
    n_pos, n_neg = y.sum(), len(y) - y.sum()
    t = np.where(y > 0.5, (n_pos + 1) / (n_pos + 2), 1.0 / (n_neg + 2))
    a, b = 1.0, 0.0
    for _ in range(iters):
        p = _sigmoid(a * s + b)
        ga = np.mean((p - t) * s)
        gb = np.mean(p - t)
        w = np.maximum(np.mean(p * (1 - p)), 1e-3)
        a = max(a - lr * ga / w, 0.0)
        b = b - lr * gb / w
    return (float(a), float(b))


def calibrate_det_protos(det_protos: Sequence[dict], method: str = "rank",
                         val_pairs: Sequence[tuple[dict, dict]] | None = None,
                         blend: float = 0.0) -> list[dict]:
    """Calibrate many videos' final det protos for pooled (multi-video) eval:
    "rank" needs no labels (``blend`` mixes raw scores back in); "platt"
    fits on ``val_pairs`` first."""
    if method == "rank":
        return [rank_normalize(dp, blend=blend) for dp in det_protos]
    if method == "platt":
        if not val_pairs:
            raise ValueError("platt calibration needs labeled val_pairs")
        cal = PlattCalibrator().fit(val_pairs)
        return [cal.transform(dp) for dp in det_protos]
    raise ValueError(f"unknown calibration method: {method}")
