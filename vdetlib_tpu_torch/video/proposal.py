"""Proposal ingestion: precomputed proposals → box_proto — the port's copy of
``vdetlib_tpu/video/proposal.py`` (the reference's ``vdetlib/vid/proposal.py``).

Per-frame proposals (Selective Search, EdgeBoxes) become a box_proto, with
optional reuse across neighbouring frames (frame t also gets the raw
proposals of frames t±w, a cheap recall boost of the reference era).

Inputs:
- MATLAB ``.mat``: ``boxes`` as a (T,) cell array of (N_t, 4) arrays, or
  one (N, 5) array whose first column is the frame index. The Selective
  Search convention ``[y1 x1 y2 x2]`` (1-based) converts with
  ``order="yxyx", one_based=True``. ``scipy.io`` is imported only here.
- ``.npz``/``.npy``: ``frame_<id>`` → (N, 4).
- ``.json``: an existing box_proto (checked and passed through).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _convert_boxes(arr: np.ndarray, order: str, one_based: bool) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float64).reshape(-1, arr.shape[-1])
    if order == "yxyx":
        arr = arr[:, [1, 0, 3, 2]]
    elif order != "xyxy":
        raise ValueError(f"unknown box order: {order}")
    if one_based:
        arr = arr - 1.0
    return arr


def load_proposals_mat(path: str, video: str, order: str = "yxyx", one_based: bool = True,
                       top_k: Optional[int] = None) -> dict:
    """Selective-Search/EdgeBoxes .mat → box_proto."""
    import scipy.io

    mat = scipy.io.loadmat(path)
    keys = [k for k in mat if not k.startswith("__")]
    boxes_entry = mat["boxes"] if "boxes" in mat else mat[keys[0]]
    out = []
    if boxes_entry.dtype == object:
        # (T,) cell array of per-frame (N_t, >=4) arrays
        for t, cell in enumerate(boxes_entry.ravel(), start=1):
            if cell is None or cell.size == 0:
                continue
            arr = _convert_boxes(cell[:, :4], order, one_based)
            if top_k:
                arr = arr[:top_k]
            for b in arr:
                out.append({"frame": t, "bbox": [float(v) for v in b]})
    else:
        arr = np.asarray(boxes_entry, dtype=np.float64)
        if arr.shape[1] < 5:
            raise ValueError(".mat without cell array needs (N, 5): frame + 4 coords")
        frames = arr[:, 0].astype(int)
        coords = _convert_boxes(arr[:, 1:5], order, one_based)
        for f, b in zip(frames, coords):
            out.append({"frame": int(f), "bbox": [float(v) for v in b]})
    return {"video": video, "boxes": out}


def load_proposals_npz(path: str, video: str, top_k: Optional[int] = None) -> dict:
    data = np.load(path, allow_pickle=True)
    out = []
    for key in data.files if hasattr(data, "files") else []:
        if not key.startswith("frame_"):
            continue
        fid = int(key.split("_", 1)[1])
        arr = np.asarray(data[key], dtype=np.float64).reshape(-1, 4)
        if top_k:
            arr = arr[:top_k]
        for b in arr:
            out.append({"frame": fid, "bbox": [float(v) for v in b]})
    out.sort(key=lambda e: e["frame"])
    return {"video": video, "boxes": out}


def load_proposals(path: str, video: str, **kw) -> dict:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mat":
        return load_proposals_mat(path, video, **kw)
    if ext in (".npz", ".npy"):
        return load_proposals_npz(path, video, top_k=kw.get("top_k"))
    if ext in (".json", ".gz"):
        from vdetlib_tpu_torch.protos import proto_load

        proto = proto_load(path)
        if "boxes" not in proto:
            raise ValueError(f"{path} is not a box_proto")
        return proto
    raise ValueError(f"unsupported proposal format: {ext}")


def reuse_across_frames(box_proto: dict, window: int, frame_ids=None) -> dict:
    """Copy each frame's proposals into its ±window neighbours (exact
    duplicates dropped): proposals are temporally stable, so a neighbour's
    are good candidates too."""
    if window <= 0:
        return box_proto
    if frame_ids is None:
        frame_ids = sorted({int(b["frame"]) for b in box_proto["boxes"]})
    id_set = set(frame_ids)
    by_frame: dict[int, list] = {}
    for b in box_proto["boxes"]:
        by_frame.setdefault(int(b["frame"]), []).append(tuple(b["bbox"]))
    out = []
    for f in frame_ids:
        merged = []
        seen = set()
        for g in range(f - window, f + window + 1):
            if g not in id_set:
                continue
            for bb in by_frame.get(g, []):
                if bb not in seen:
                    seen.add(bb)
                    merged.append(bb)
        for bb in merged:
            out.append({"frame": f, "bbox": list(bb)})
    return {**{k: v for k, v in box_proto.items() if k != "boxes"}, "boxes": out}
