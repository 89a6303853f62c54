"""Seq-NMS paths as tubelets — counterpart of ``vdetlib_tpu/video/link.py``.

The numpy ``tubelets_from_path_ids`` and the stage's options
(``LinkOptions``, which the pipeline config tree reads) are ported here; the
staged link stage (``seq_nms_video``) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LinkOptions:
    """Same fields and defaults as the JAX ``LinkOptions``."""

    link_thresh: float = 0.5
    suppress_thresh: float = 0.3
    max_paths: int = 100
    rescore: str = "avg"  # avg | max
    max_boxes: int = 64
    num_classes: int = 31
    min_score: float = 0.0  # drop rescored entries at/below this
    backend: str = "device"  # device | host


def tubelets_from_path_ids(boxes, out_scores, path_ids, fids, video: str,
                           first_class: int = 1) -> dict:
    """Extract seq-NMS paths as a track_proto (one track per (class, path)).

    boxes (T, N, 4); out_scores/path_ids (L, T, N) per-class seq-NMS scores
    and path ids (-1 = none); lane ``l`` is class ``first_class + l``.
    """
    boxes = np.asarray(boxes)
    out_scores = np.asarray(out_scores)
    path_ids = np.asarray(path_ids)
    tracks = []
    L, T = path_ids.shape[:2]
    for lane in range(L):
        c = first_class + lane
        pids = path_ids[lane]
        for pid in range(int(pids.max()) + 1 if pids.size else 0):
            entries = []
            for t in range(T):
                ns = np.nonzero(pids[t] == pid)[0]
                if ns.size == 0:
                    continue
                n = int(ns[0])
                entries.append(
                    {
                        "frame": int(fids[t]),
                        "bbox": [float(v) for v in boxes[t, n]],
                        "score": float(out_scores[lane, t, n]),
                        "class_index": c,
                    }
                )
            if entries:
                tracks.append(entries)
    return {"video": video, "method": "seq_nms", "tracks": tracks}
