"""ImageNet VID detection mAP (per-class AP, IoU 0.5) — the port's copy of
``vdetlib_tpu/evaluation/vid_map.py`` (same functions, same results).

Reference parity: the ILSVRC VID devkit evaluation (SURVEY.md §2.2 "Eval" —
out-of-repo MATLAB in the reference era; rebuilt here in numpy). Standard
greedy matching: detections sorted by score, each matches the best unmatched
ground-truth box of its class in its frame when IoU ≥ thresh; AP is the
area under the interpolated precision-recall curve (all-points, VOC2010+).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np

from vdetlib_tpu_torch.utils.common import iou as iou_matrix


def _gt_from_annot(annot_proto: dict):
    """annot_proto → {(frame, class_index): [bbox, ...]}"""
    gt = defaultdict(list)
    for ann in annot_proto.get("annotations", []):
        for box in ann["track"]:
            ci = box.get("class_index")
            if ci is None:
                ci = int(box["class"]) if str(box.get("class", "")).isdigit() else None
            if ci is None:
                continue
            gt[(int(box["frame"]), int(ci))].append(box["bbox"])
    return gt


def per_class_ap(
    pairs: Sequence[tuple[dict, dict]],
    iou_thresh: float = 0.5,
) -> dict[int, float]:
    """AP per class over (det_proto, annot_proto) pairs (one per video).

    Returns {class_index: AP}; classes with zero GT instances are skipped.
    """
    # collect per-class detections and GT across videos
    dets = defaultdict(list)  # ci -> [(score, vid_idx, frame, bbox)]
    gts = {}  # (vid_idx, frame, ci) -> [bboxes]
    n_gt = defaultdict(int)
    for vi, (det_proto, annot_proto) in enumerate(pairs):
        gt = _gt_from_annot(annot_proto)
        for (frame, ci), boxes in gt.items():
            gts[(vi, frame, ci)] = boxes
            n_gt[ci] += len(boxes)
        for d in det_proto["detections"]:
            for s in d["scores"]:
                dets[int(s["class_index"])].append(
                    (float(s["score"]), vi, int(d["frame"]), d["bbox"])
                )

    aps = {}
    for ci, cls_gt_count in n_gt.items():
        cls_dets = sorted(dets.get(ci, []), key=lambda r: -r[0])
        matched: dict[tuple, np.ndarray] = {}
        tp = np.zeros(len(cls_dets))
        fp = np.zeros(len(cls_dets))
        for di, (score, vi, frame, bbox) in enumerate(cls_dets):
            key = (vi, frame, ci)
            gt_boxes = gts.get(key)
            if not gt_boxes:
                fp[di] = 1
                continue
            if key not in matched:
                matched[key] = np.zeros(len(gt_boxes), bool)
            m = iou_matrix([bbox], gt_boxes)[0]
            order = np.argsort(-m)
            hit = False
            for gi in order:
                if m[gi] < iou_thresh:
                    break
                if not matched[key][gi]:
                    matched[key][gi] = True
                    hit = True
                    break
            tp[di] = 1 if hit else 0
            fp[di] = 0 if hit else 1
        if len(cls_dets) == 0:
            aps[ci] = 0.0
            continue
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        recall = ctp / cls_gt_count
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        aps[ci] = _voc_ap(recall, precision)
    return aps


def _voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-points interpolated AP (VOC 2010+ / COCO style AUC)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def vid_map(
    pairs: Sequence[tuple[dict, dict]], iou_thresh: float = 0.5
) -> tuple[float, dict[int, float]]:
    """Mean AP over classes with GT. Returns (mAP, per-class dict)."""
    aps = per_class_ap(pairs, iou_thresh)
    if not aps:
        return 0.0, {}
    return float(np.mean(list(aps.values()))), aps
