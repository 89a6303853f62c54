"""Bytes and operations that a stage's inputs need, for the stage rooflines.

Each function counts what one call of a stage needs at its shapes: each
input byte read once, each output byte written once, and the arithmetic of
the algorithm on these inputs (the operation counts of the port's kernel
bounds, ``chip_smoke.py``: 30 float32 operations a pixel and shift for block
matching, 5 for a box's area and 15 for an IoU decision). Where the work
depends on data the benchmark cannot see from outside the program, only the
part it can see is counted, so the bound stays a lower bound and a share of
it can never pass 100% by a miscount. A stage's roofline share is
``bound_s`` over all device time launched inside its span, whatever kernels
implement it.
"""

from __future__ import annotations

from portbench.yardstick.flops import HBM_BYTES_PER_S, PEAK_F32_FLOPS, tracker_stride

AREA_OPS, IOU_OPS = 5, 15
FLOW_SEARCH, FLOW_RADIUS = 5, 3
FLOW_POOL = {"fast": 2, "fastest": 4}


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take: bytes at HBM speed or float32
    operations at the SIMT peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_F32_FLOPS)


def flow_ops(n_pairs: int, h: int, w: int, preset: str) -> float:
    """Gray conversion and pooling of the frames' pairs, and block matching
    on the preset's grid (search ±5, radius 3)."""
    pool = FLOW_POOL[preset]
    hp, wp = h // pool, w // pool
    per_shift = 2 + 2 * (2 * FLOW_RADIUS) + 1 + 15
    matching = n_pairs * hp * wp * (2 * FLOW_SEARCH + 1) ** 2 * per_shift
    gray = (n_pairs + 1) * h * w * (5 + 2)
    return float(matching + gray)


def fused_flow(t: int, hw, preset: str) -> float:
    """``fused.flow``: both directions over ``t`` frames → two (t-1) fields."""
    h, w = hw
    pool = FLOW_POOL[preset]
    n_bytes = t * h * w * 3 + 2 * (t - 1) * (h // pool) * (w // pool) * 2 * 4
    return bound_s(n_bytes, 2 * flow_ops(t - 1, h, w, preset))


def fused_nms_dedup(t: int, slots: int) -> float:
    """``fused.nms_dedup``: per-frame per-class greedy NMS over ``slots``
    propagated slots a frame. Inputs boxes, scores, valid, class; output
    keep; the slots' areas. The IoUs depend on which slots are valid, which
    the program keeps to itself: not counted."""
    n = t * slots
    return bound_s(n * (16 + 4 + 1 + 4) + n, AREA_OPS * n)


def fused_track_rounds(t: int, hw, trk: dict, fused: dict) -> float:
    """``fused.track_rounds``: the tracker features of the sampled frames
    read once, the candidates (boxes, scores, mask) read, the K tracks
    (boxes, conf, alive) written, and each round's templates pooled. How
    far each lane tracks depends on the rollouts: not counted."""
    h, w = hw
    s = tracker_stride(trk)
    t_s = -(-t // fused["track_stride"])
    feat = t_s * (h // s) * (w // s) * trk["out_features"] * 2
    slots = t * fused["det_budget"] * (2 * fused["mgp_window"] + 1)
    k = fused["max_tracks"]
    n_bytes = feat + slots * (16 + 4 + 1) + k * t * (16 + 4 + 1)
    P = trk["template_pool"]
    ops = k * P * P * trk["out_features"] * 2 * ((h // s) + P)
    return bound_s(n_bytes, ops)


def nms_pairs(valid_counts) -> int:
    """IoU decisions a greedy NMS needs at least: each valid pair once."""
    return int(sum(n * (n - 1) // 2 for n in valid_counts))


def stream_nms(chunk: int, classes: int, rois: int, valid_counts) -> float:
    """``stream.nms`` over one chunk: (chunk × classes) problems of ``rois``
    slots with per-class boxes; ``valid_counts``: valid slots a problem."""
    n = chunk * classes * rois
    return bound_s(n * (16 + 4 + 1) + n,
                   AREA_OPS * sum(valid_counts) + IOU_OPS * nms_pairs(valid_counts))


def stream_mgp(chunk: int, hw, classes: int, rois: int, preset: str, valid_counts) -> float:
    """``stream.mgp`` and ``stream.mgp_nms`` over one chunk: flow both ways
    over the chunk and its halo frame, the boxes shifted, and the dedup NMS
    of (chunk × classes) problems of 3R slots sharing their boxes;
    ``valid_counts``: slots a problem that can be valid (score above 0)."""
    h, w = hw
    pool = FLOW_POOL[preset]
    n = chunk * classes * 3 * rois
    n_bytes = ((chunk + 1) * h * w * 3 + 2 * chunk * (h // pool) * (w // pool) * 2 * 4
               + chunk * 3 * rois * 16 + n * (4 + 1) + n)
    ops = (2 * flow_ops(chunk, h, w, preset) + AREA_OPS * sum(valid_counts)
           + IOU_OPS * nms_pairs(valid_counts))
    return bound_s(n_bytes, ops)
