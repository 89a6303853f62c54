"""The card's peaks and the analytic FLOP model of the engines.

A frozen copy of the port's ``utils/flops.py`` (2·MAC for every convolution
and matmul; arithmetic-op counts for the stages that run as elementwise
work), taking a configuration file's plain mappings instead of the port's
config objects; a detector's own terms are its architecture module's
``detect_flops`` (``portbench/architectures/``). ``portbench/tests`` holds it
equal to the port's model at the cells' shapes.

MFU convention: model FLOPs ÷ (seconds × the card's bf16 dense tensor-core
peak), whatever unit or dtype each op really runs on.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def conv2d(h_out: int, w_out: int, kh: int, kw: int, cin: int, cout: int) -> float:
    return 2.0 * h_out * w_out * kh * kw * cin * cout


def roi_align_flops(h_f: int, w_f: int, c: int, pool: int, n_rois: int) -> float:
    per_roi = 2.0 * pool * h_f * w_f * c + 2.0 * pool * pool * w_f * c
    return n_rois * per_roi


def tracker_stride(trk: dict) -> int:
    return 2 ** min(2, len(trk["features"]))


def tracker_feat_flops(trk: dict, h: int, w: int) -> float:
    total = 0.0
    cin = 3
    hs, ws = h, w
    for i, feats in enumerate(trk["features"]):
        stride = 2 if i < 2 else 1
        hs, ws = hs // stride, ws // stride
        total += conv2d(hs, ws, 3, 3, cin, feats)
        cin = feats
    total += conv2d(hs, ws, 1, 1, cin, trk["out_features"])
    return total


def ncc_step_flops(trk: dict, h: int, w: int) -> float:
    """One lane's NCC step: the search window's pooling and the correlation
    (response + local-norm sums)."""
    s = tracker_stride(trk)
    hf, wf = h // s, w // s
    c = trk["out_features"]
    P = trk["template_pool"]
    Q = int(round(P * trk["search_factor"]))
    r = Q - P + 1
    return roi_align_flops(hf, wf, c, Q, 1) + 2.0 * r * r * P * P * c * 2


def template_flops(trk: dict, h: int, w: int, n: int) -> float:
    s = tracker_stride(trk)
    return roi_align_flops(h // s, w // s, trk["out_features"], trk["template_pool"], n)


def tracker_scan_flops(trk: dict, h: int, w: int, t: int, anchors: int) -> float:
    """The folded forward+backward scan: 2A lanes × T steps (one scale)."""
    lanes = 2 * anchors * max(1, trk["num_scales"])
    return lanes * t * ncc_step_flops(trk, h, w) + template_flops(trk, h, w, 2 * anchors)


def flow_flops(h: int, w: int, n_pairs: int, preset: str = "fastest",
               search: int = 5, radius: int = 3) -> float:
    pool = {"accurate": 1, "fast": 2, "fastest": 4}[preset]
    hp, wp = h // pool, w // pool
    s2 = (2 * search + 1) ** 2
    per_px_cand = 2 + (2 * (2 * radius + 1) + 1) + 14
    return float(n_pairs) * hp * wp * s2 * per_px_cand


def iou_matrix_flops(n: int, m: int) -> float:
    return 12.0 * n * m


def nms_grouped_flops(t: int, group: int, iters: int = 8) -> float:
    return t * (iou_matrix_flops(group, group) + iters * 3.0 * group * group)


def seq_nms_flops(t: int, n: int, classes: int, max_paths: int) -> float:
    adj = (t - 1) * iou_matrix_flops(n, n)
    per_round = (t - 1) * 4.0 * n * n + t * 3.0 * n
    return classes * (adj + max_paths * per_round)


def rescore_flops(t: int, k: int, n: int, c: int) -> float:
    return t * k * iou_matrix_flops(1, n) + 2.0 * t * k * n * c


def fused_dispatch_flops(arch, det: dict, trk: dict, fused: dict, t: int, n_rois: int) -> dict:
    """Per-component FLOPs of one fused-pipeline call over a video of ``t``
    frames and ``n_rois`` proposals a frame (the port's component names);
    ``arch`` is the detector's architecture module, ``det`` its section."""
    h, w = fused["image_hw"]
    c = det["num_classes"]
    t_trk = -(-t // fused["track_stride"])
    detect = {k: t * v for k, v in arch.detect_flops(det, h, w, n_rois).items()}
    return {
        **detect,
        "track/features": t_trk * tracker_feat_flops(trk, h, w),
        "track/ncc_scan": tracker_scan_flops(trk, h, w, t_trk, fused["anchors_per_round"]),
        "mgp/flow": flow_flops(h, w, 2 * (t - 1), preset=fused["flow_preset"]),
        "mgp/nms_grouped": nms_grouped_flops(t, fused["det_budget"]
                                             * (2 * fused["mgp_window"] + 1)),
        "rescore": rescore_flops(t, fused["max_tracks"], fused["out_budget"], c),
        "seq_nms": seq_nms_flops(t, fused["out_budget"], c - 1, fused["max_paths"]),
    }


def stream_chunk_flops(arch, det: dict, trk: dict, stream: dict, hw) -> dict:
    """Per-component FLOPs of one full chunk of the stream engine (stride 1):
    detection, per-frame NMS, flow over the chunk and its halo both ways, the
    MGP dedup, the tracker's features, the slots' NCC steps and the
    backtrack's (one lane a slot over the previous and the current chunk);
    ``arch`` and ``det`` as :func:`fused_dispatch_flops` takes them."""
    h, w = hw
    L, R, C, A = stream["chunk"], stream["max_rois"], stream["num_classes"], stream["track_slots"]
    return {
        "detect": L * sum(arch.detect_flops(det, h, w, R).values()),
        "nms": L * (C - 1) * (iou_matrix_flops(R, R) + 8 * 3.0 * R * R),
        "mgp/flow": flow_flops(h, w, 2 * L, preset=stream["flow_preset"]),
        "mgp/nms": L * (C - 1) * (iou_matrix_flops(3 * R, 3 * R) + 8 * 3.0 * 9 * R * R),
        "track/features": L * tracker_feat_flops(trk, h, w),
        "track/ncc": A * L * ncc_step_flops(trk, h, w) + template_flops(trk, h, w, A),
        "track/backtrack": A * 2 * L * ncc_step_flops(trk, h, w),
    }
