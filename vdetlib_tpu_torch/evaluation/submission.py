"""ILSVRC VID submission writer — the port's copy of
``vdetlib_tpu/evaluation/submission.py``: one line per detection score,
``frame_idx class_idx score x1 y1 x2 y2``, frames numbered globally across
the evaluated video set."""

from __future__ import annotations

from typing import Sequence


def submission_lines(det_proto: dict, frame_offset: int = 0,
                     min_score: float = 0.0) -> list[str]:
    """det_proto → submission lines; frame ids shifted by ``frame_offset``.

    ``min_score`` drops score entries below the cutoff, a precision knob
    once scores are Platt-calibrated TP probabilities
    (``evaluation/calibration.py``)."""
    lines = []
    for d in sorted(det_proto["detections"], key=lambda d: d["frame"]):
        x1, y1, x2, y2 = d["bbox"]
        for s in d["scores"]:
            if float(s["score"]) < min_score:
                continue
            lines.append(
                f"{d['frame'] + frame_offset} {int(s['class_index'])} "
                f"{float(s['score']):.6f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}"
            )
    return lines


def write_submission(det_protos: Sequence[dict], vid_protos: Sequence[dict], path: str,
                     min_score: float = 0.0) -> int:
    """Write a multi-video submission with global frame numbering; returns
    the number of lines."""
    offset = 0
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for det, vid in zip(det_protos, vid_protos):
            lines = submission_lines(det, frame_offset=offset, min_score=min_score)
            for line in lines:
                f.write(line + "\n")
            n += len(lines)
            offset += len(vid["frames"])
    return n
