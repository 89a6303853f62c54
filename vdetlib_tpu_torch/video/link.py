"""Seq-NMS suppression stage — counterpart of ``vdetlib_tpu/video/link.py``.

Consumes the (rescored) det_proto, runs per-class seq-NMS and emits the
suppressed det_proto and the paths as tubelets (a track_proto, one track a
(class, path)). Backends, with the JAX package's names: ``device``
(``kernels/seq_nms.py::seq_nms_batch`` over all class lanes on ``device``,
fixed-trip loops with no host synchronisation) and ``host``
(``kernels/seq_nms_host.py``, numpy). Both give the same path ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vdetlib_tpu_torch.kernels.seq_nms import seq_nms_batch
from vdetlib_tpu_torch.kernels.seq_nms_host import seq_nms_batch_host
from vdetlib_tpu_torch.protos.accessors import frame_ids as get_frame_ids
from vdetlib_tpu_torch.protos.arrays import arrays_to_det_proto, det_proto_to_arrays
from vdetlib_tpu_torch.utils.log import StageMetrics

__all__ = ["LinkOptions", "path_counts", "seq_nms_video", "tubelets_from_path_ids"]


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


def path_counts(path_ids, max_paths: int) -> dict:
    """Seq-NMS's work, read from its path ids (L, T, N) (-1 = none): a lane
    finds its largest path id + 1 paths, one an iteration until it runs out.
    ``paths``: found over all lanes; ``path_iters_live``: the iterations
    after which every lane had run out (the most found by one lane);
    ``path_iters_run``: the ``max_paths`` iterations that ran."""
    found = np.asarray(path_ids).reshape(len(path_ids), -1).max(1, initial=-1) + 1
    return {"paths": int(found.sum()), "path_iters_live": int(found.max(initial=0)),
            "path_iters_run": int(max_paths)}


def seq_nms_video(vid_proto: dict, det_proto: dict, opts: LinkOptions = LinkOptions(),
                  device="cuda") -> tuple[dict, dict]:
    """Run seq-NMS over one video → (det_proto, track_proto of tubelets).

    Each class is a problem over the shared boxes; a detection takes part
    in class c where its score for c is positive. The ``device`` backend runs
    on ``device`` (the card unless the caller asks for the CPU); ``host``
    runs in numpy. Tubelets come from the foreground lanes 1..C-1."""
    metrics = StageMetrics("seq_nms")
    fids = get_frame_ids(vid_proto)
    boxes, scores, mask = det_proto_to_arrays(det_proto, fids, opts.max_boxes, opts.num_classes)
    cls_scores = np.moveaxis(scores, 2, 0)  # (C, T, N)
    cls_mask = (cls_scores > 0) & mask[None]
    if opts.backend == "host":
        out_scores, path_ids = seq_nms_batch_host(
            boxes, cls_scores, cls_mask, opts.link_thresh, opts.suppress_thresh,
            max_paths=opts.max_paths, rescore=opts.rescore)
    elif opts.backend == "device":
        dev = torch.device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        out_scores, path_ids = seq_nms_batch(
            put(boxes), put(cls_scores), put(cls_mask), opts.link_thresh, opts.suppress_thresh,
            max_paths=opts.max_paths, rescore=opts.rescore)
        out_scores = out_scores.cpu().numpy()  # (C, T, N); -1 = suppressed
        path_ids = path_ids.cpu().numpy()
    else:
        raise ValueError(f"unknown seq-NMS backend: {opts.backend}")

    # surviving entries carry their rescored scores
    new_scores = np.moveaxis(np.maximum(out_scores, 0.0), 0, 2)  # (T, N, C)
    det_out = arrays_to_det_proto(boxes, new_scores, mask, fids, vid_proto["video"],
                                  score_thresh=opts.min_score)
    track_proto = tubelets_from_path_ids(boxes, out_scores[1:], path_ids[1:], fids,
                                         vid_proto["video"], first_class=1)
    metrics.set("frames", len(fids))
    metrics.set("dets_in", len(det_proto["detections"]))
    metrics.set("dets_out", len(det_out["detections"]))
    metrics.set("tubelets", len(track_proto["tracks"]))
    metrics.finish()
    return det_out, track_proto
