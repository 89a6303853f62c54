"""Per-frame, per-class NMS over a det_proto — counterpart of
``vdetlib_tpu/video/frame_nms.py`` (config 1 of the capability contract,
``BASELINE.json:7``): load a vid_proto and a det_proto, run greedy NMS
independently per frame and per class, write the filtered det_proto.

Backends, with the JAX package's names so that commands carry over, and
identical keep sets:

- ``host``: greedy NMS per (frame, class) in the native host library
  (``kernels/nms.py::nms_host``), no device involved;
- ``pallas``: pad to (T·C, N) and run the hand kernels that replace the
  Pallas ones on ``device``, routed as the JAX ``batched_nms_pallas`` routes:
  N <= 128 → kernel C, N > 128 → kernel D (up to its 8,192 slots on a card,
  above which D's wrapper raises: the JAX Pallas kernel has a VMEM limit of
  the same kind);
- ``xla``: the same route as ``pallas`` up to D's limit (the JAX package's
  XLA fixpoint computes the same keep sets), and above it the sort-free
  fixpoint (``kernels/nms.py::nms_unsorted_fixpoint``) in torch ops, over
  at most ``FIXPOINT_ELEMS`` adjacency entries a pass;
- ``fixpoint``: the same padding, then the sorted Jacobi form
  (``kernels/nms.py::nms_fixpoint``, batched matrix-vector products) on
  ``device``, over at most ``FIXPOINT_ELEMS`` adjacency entries a pass.

A detection takes part in class c's NMS only where it carries a score entry
for c; it keeps the classes where it survived, and a detection with none
left is dropped. The device backends take the first ``max_boxes``
detections of each frame in file order.
"""

from __future__ import annotations

import numpy as np
import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET
from vdetlib_tpu_torch.kernels.nms import (
    FIXPOINT_ELEMS,
    fixpoint_passes,
    nms_fixpoint,
    nms_host,
    nms_unsorted_fixpoint,
)
from vdetlib_tpu_torch.kernels.nms_batched import MAX_SLOTS as _BATCHED_MAX
from vdetlib_tpu_torch.kernels.nms_batched import nms_batched_kernel
from vdetlib_tpu_torch.kernels.nms_sorted import MAX_SLOTS as _SORTED_MAX
from vdetlib_tpu_torch.kernels.nms_sorted import nms_sorted_kernel
from vdetlib_tpu_torch.protos.accessors import det_class_indices, frame_ids

BACKENDS = ("host", "xla", "fixpoint", "pallas")
# FIXPOINT_ELEMS bounds a pass of the fixpoint forms: 1,920 problems of 512
# boxes would take 2 GiB of float32 adjacency in one pass


def frame_nms(vid_proto: dict, det_proto: dict, thresh: float = 0.3, backend: str = "host",
              offset: float = LEGACY_OFFSET, max_boxes: int = 512, device="cuda") -> dict:
    """Apply per-frame per-class NMS; returns a filtered det_proto.

    The device backends run on ``device`` (the card unless the caller asks
    for the CPU, where the kernels' plain versions run)."""
    if backend == "host":
        return _frame_nms_host(vid_proto, det_proto, thresh, offset)
    if backend in ("xla", "fixpoint", "pallas"):
        return _frame_nms_device(vid_proto, det_proto, thresh, offset, max_boxes,
                                 torch.device(device), backend)
    raise ValueError(f"unknown backend: {backend}")


def _collect(det_proto: dict):
    """{frame_id: [(det_index, det_dict), ...]} in file order."""
    by_frame: dict[int, list[tuple[int, dict]]] = {}
    for i, d in enumerate(det_proto["detections"]):
        by_frame.setdefault(int(d["frame"]), []).append((i, d))
    return by_frame


def _frame_nms_host(vid_proto, det_proto, thresh, offset) -> dict:
    by_frame = _collect(det_proto)
    classes = det_class_indices(det_proto)
    kept_pairs: set[tuple[int, int]] = set()  # surviving (det_index, class_index)
    for fid in frame_ids(vid_proto):
        entries = by_frame.get(fid, [])
        if not entries:
            continue
        for c in classes:
            rows, idxs = [], []
            for det_idx, d in entries:
                for s in d["scores"]:
                    if int(s["class_index"]) == c:
                        rows.append(list(d["bbox"]) + [float(s["score"])])
                        idxs.append(det_idx)
                        break
            if not rows:
                continue
            for k in nms_host(np.asarray(rows, dtype=np.float32), thresh, offset):
                kept_pairs.add((idxs[k], c))
    return _filter_det_proto(det_proto, kept_pairs)


def pack_frame_problems(vid_proto: dict, det_proto: dict, max_boxes: int):
    """The device backends' problems: the first ``max_boxes`` detections of
    each frame, in file order, as (boxes (T, N, 4) f32, scores (T, C, N) f32,
    has_entry (T, C, N) bool, det_index (T, N) int64 with -1 on empty slots,
    classes), N = ``max_boxes`` and C the det_proto's classes."""
    by_frame = _collect(det_proto)
    classes = det_class_indices(det_proto)
    fids = frame_ids(vid_proto)
    T, C, N = len(fids), len(classes), max_boxes
    boxes = np.zeros((T, N, 4), dtype=np.float32)
    scores = np.zeros((T, C, N), dtype=np.float32)
    has_entry = np.zeros((T, C, N), dtype=bool)
    det_index = -np.ones((T, N), dtype=np.int64)
    class_slot = {ci: c for c, ci in enumerate(classes)}
    for t, fid in enumerate(fids):
        for n, (det_idx, d) in enumerate(by_frame.get(fid, [])[:N]):
            boxes[t, n] = np.asarray(d["bbox"], dtype=np.float32)
            det_index[t, n] = det_idx
            for s in d["scores"]:
                c = class_slot.get(int(s["class_index"]))
                if c is not None:
                    scores[t, c, n] = float(s["score"])
                    has_entry[t, c, n] = True
    return boxes, scores, has_entry, det_index, classes


def _frame_nms_device(vid_proto, det_proto, thresh, offset, max_boxes, device,
                      backend) -> dict:
    boxes, scores, has_entry, det_index, classes = pack_frame_problems(vid_proto, det_proto,
                                                                       max_boxes)
    T, C, N = scores.shape
    b = torch.from_numpy(boxes).to(device)[:, None].expand(T, C, N, 4).reshape(T * C, N, 4)
    s = torch.from_numpy(scores).to(device).reshape(T * C, N)
    v = torch.from_numpy(has_entry).to(device).reshape(T * C, N)
    with torch.no_grad():
        if backend == "fixpoint":
            keep = fixpoint_passes(lambda *a: nms_fixpoint(*a, thresh, offset), b, s, v,
                                   max_elems=FIXPOINT_ELEMS)
        elif backend == "xla" and N > _SORTED_MAX:
            keep = fixpoint_passes(lambda *a: nms_unsorted_fixpoint(*a, thresh, offset), b, s, v,
                                   max_elems=FIXPOINT_ELEMS)
        else:
            kernel = nms_batched_kernel if N <= _BATCHED_MAX else nms_sorted_kernel
            keep = kernel(b.contiguous(), s, v, thresh, offset)
    keep = keep.reshape(T, C, N).cpu().numpy() & has_entry
    kept_pairs: set[tuple[int, int]] = set()
    for t, c, n in zip(*np.nonzero(keep)):
        kept_pairs.add((int(det_index[t, n]), classes[c]))
    return _filter_det_proto(det_proto, kept_pairs)


def _filter_det_proto(det_proto: dict, kept_pairs: set[tuple[int, int]]) -> dict:
    detections = []
    for i, d in enumerate(det_proto["detections"]):
        surviving = [s for s in d["scores"] if (i, int(s["class_index"])) in kept_pairs]
        if surviving:
            detections.append({"frame": d["frame"], "bbox": d["bbox"], "scores": surviving})
    out = {k: v for k, v in det_proto.items() if k != "detections"}
    out["detections"] = detections
    return out
