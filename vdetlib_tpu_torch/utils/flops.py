"""Analytic FLOP model of the fused pipeline — the port's copy of
``vdetlib_tpu/utils/flops.py``, priced for one NVIDIA H100.

Counts 2·MAC for every convolution and matmul, and arithmetic-op counts for
the stages that run as elementwise (SIMT) work: the flow cost volume, the NMS
fixpoint, the seq-NMS dynamic programme and the IoU tensors. Elementwise glue
(GroupNorm, relu, softmax, warps, pads) is left out: it is bound by memory,
not by arithmetic. ``tests/test_torch_flops.py`` holds the detect step and
the tracker features against ``torch.utils.flop_counter.FlopCounterMode``.

MFU convention: model FLOPs ÷ (wall × the card's bf16 dense tensor-core
peak), whatever dtype or unit each op really runs on (the standard MFU
definition: it counts float32 and SIMT work at the tensor-core rate).

The functions take the port's config objects (``nn/presets.py``,
``nn/tracker_net.py::TrackerConfig``, ``pipeline/fused.py::FusedConfig``), so
a preset change reprices automatically; :func:`detect_flops` prices a
detector by its kind (``Detector`` or ``RFCN``), under the same three names.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W.
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores: the MFU convention's peak
PEAK_F32_FLOPS = 67e12  # float32 on the SIMT cores (no tensor cores)
HBM_BYTES_PER_S = 3.35e12  # HBM3

# the card's two classes of work
MATMUL = "matmul"  # convolutions and matmuls (tensor cores where bf16)
SIMT = "simt"  # elementwise and reductions on the CUDA cores


def conv2d(h_out: int, w_out: int, kh: int, kw: int, cin: int, cout: int) -> float:
    return 2.0 * h_out * w_out * kh * kw * cin * cout


def dense(n: int, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


@dataclass(frozen=True)
class ComponentFlops:
    """FLOPs for one pipeline component at one call's shapes."""

    name: str
    flops: float
    unit: str  # MATMUL | SIMT
    note: str = ""


def backbone_flops(cfg, h: int, w: int) -> float:
    """Per-image conv FLOPs of ``nn/backbone.py::Backbone`` (2·MAC)."""
    total = 0.0
    h2, w2 = h // 2, w // 2  # stem: 7x7 stride 2
    total += conv2d(h2, w2, 7, 7, 3, cfg.stem_features)
    hs, ws = h2 // 2, w2 // 2  # max pool stride 2 (no MACs)
    cin = cfg.stem_features
    for si, (n_blocks, feats) in enumerate(zip(cfg.stage_sizes, cfg.stage_features)):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            hs, ws = hs // stride, ws // stride
            total += conv2d(hs, ws, 3, 3, cin, feats)  # conv1 (strided)
            total += conv2d(hs, ws, 3, 3, feats, feats)  # conv2
            if cin != feats or stride != 1:  # 1x1 projection
                total += conv2d(hs, ws, 1, 1, cin, feats)
            cin = feats
    return total


def roi_align_flops(h_f: int, w_f: int, c: int, pool: int, n_rois: int) -> float:
    """Separable-matmul ROI align (``nn/heads.py::roi_align``)."""
    per_roi = 2.0 * pool * h_f * w_f * c + 2.0 * pool * pool * w_f * c
    return n_rois * per_roi


def rcnn_head_flops(pool: int, c: int, hidden: int, num_classes: int, n_rois: int) -> float:
    d_in = pool * pool * c
    per_roi = (
        2.0 * d_in * hidden
        + 2.0 * hidden * hidden
        + 2.0 * hidden * num_classes
        + 2.0 * hidden * num_classes * 4
    )
    return n_rois * per_roi


def conv_out(n: int, k: int, stride: int, pad: int, dilation: int = 1) -> int:
    """A convolution's output size along one axis (Caffe's and torch's rule)."""
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def rfcn_trunk_flops(cfg, h: int, w: int) -> tuple[float, int, int]:
    """Per-image conv FLOPs of ``nn/rfcn.py::Trunk`` → (FLOPs, map rows, map columns)."""
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    total = conv2d(h, w, 7, 7, 3, cfg.stem_features)
    h, w = -(-(h - 3) // 2) + 1, -(-(w - 3) // 2) + 1  # Caffe's 3x3/2 max-pool, rounded up
    cin = cfg.stem_features
    last = len(cfg.stage_sizes) - 1
    for si, (n, mid, out) in enumerate(zip(cfg.stage_sizes, cfg.bottleneck_features,
                                           cfg.stage_features)):
        for b in range(n):
            stride = 2 if (b == 0 and 0 < si < last) else 1
            h, w = conv_out(h, 1, stride, 0), conv_out(w, 1, stride, 0)
            total += (conv2d(h, w, 1, 1, cin, mid) + conv2d(h, w, 3, 3, mid, mid)
                      + conv2d(h, w, 1, 1, mid, out))
            if cin != out or stride != 1:  # 1x1 projection
                total += conv2d(h, w, 1, 1, cin, out)
            cin = out
    return total, h, w


def psroi_flops(h_f: int, w_f: int, groups: int, k: int, n_rois: int) -> float:
    """PS-ROI pooling from a summed-area table and voting (``nn/rfcn.py``):
    two adds a map element for the table, three adds and a division a bin
    and group for its mean, one operation a bin and group for the vote."""
    return 2.0 * h_f * w_f * groups * k * k + n_rois * groups * k * k * (4 + 1)


def detect_flops(det_cfg, h: int, w: int, n_rois: int) -> list[ComponentFlops]:
    """One frame's detection FLOPs by component: ``detect/backbone``,
    ``detect/roi_align`` (R-FCN: PS-ROI pooling and voting, SIMT work) and
    ``detect/head`` (R-FCN: the reduction and the maps)."""
    from vdetlib_tpu_torch.nn.rfcn import RFCNConfig

    c = det_cfg.num_classes
    if isinstance(det_cfg, RFCNConfig):
        trunk, hf, wf = rfcn_trunk_flops(det_cfg, h, w)
        k, red = det_cfg.ps_pool, det_cfg.reduce_features
        maps = k * k * (c + 4)
        return [
            ComponentFlops("detect/backbone", trunk, MATMUL,
                           f"@ {h}x{w}, bottleneck resnet, conv5 dilated "
                           f"{det_cfg.conv5_dilation}"),
            ComponentFlops("detect/roi_align", psroi_flops(hf, wf, c + 4, k, n_rois), SIMT,
                           f"{n_rois} rois/frame, PS-ROI pooling {k}x{k} and voting"),
            ComponentFlops("detect/head", conv2d(hf, wf, 1, 1, det_cfg.stage_features[-1], red)
                           + conv2d(hf, wf, 1, 1, red, maps), MATMUL,
                           f"1x1 reduction to {red}, {maps} maps"),
        ]
    bb = det_cfg.backbone
    hf, wf, cf = h // 16, w // 16, bb.stage_features[-1]
    return [
        ComponentFlops("detect/backbone", backbone_flops(bb, h, w), MATMUL,
                       f"@ {h}x{w}, stride-16 resnet"),
        ComponentFlops("detect/roi_align", roi_align_flops(hf, wf, cf, det_cfg.roi_pool, n_rois),
                       MATMUL, f"{n_rois} rois/frame, separable bilinear matmuls"),
        ComponentFlops("detect/head",
                       rcnn_head_flops(det_cfg.roi_pool, cf, det_cfg.head_hidden, c, n_rois),
                       MATMUL, f"2x dense({det_cfg.head_hidden}) + cls/bbox"),
    ]


def tracker_feat_flops(trk_cfg, h: int, w: int) -> float:
    """Per-frame conv FLOPs of ``nn/tracker_net.py::TrackerNet``."""
    total = 0.0
    cin = 3
    hs, ws = h, w
    for i, feats in enumerate(trk_cfg.features):
        stride = 2 if i < 2 else 1
        hs, ws = hs // stride, ws // stride
        total += conv2d(hs, ws, 3, 3, cin, feats)
        cin = feats
    total += conv2d(hs, ws, 1, 1, cin, trk_cfg.out_features)
    return total


def tracker_scan_flops(trk_cfg, h: int, w: int, t: int, anchors: int) -> float:
    """Folded fwd+bwd NCC scan (``video/track.py::track_batch``, kernel F):
    2A lanes × T steps × num_scales; a lane-step pools the search window (pool
    Q over the stride-4 feature map) and correlates (response + local-norm
    sums)."""
    hf, wf = h // trk_cfg.stride, w // trk_cfg.stride
    c = trk_cfg.out_features
    P, Q = trk_cfg.template_pool, trk_cfg.search_pool
    align = roi_align_flops(hf, wf, c, Q, 1)
    r = Q - P + 1  # response side
    corr = 2.0 * r * r * P * P * c * 2  # response + squared-norm sums
    lanes = 2 * anchors * max(1, trk_cfg.num_scales)
    template = roi_align_flops(hf, wf, c, P, 2 * anchors)  # once per lane
    return lanes * t * (align + corr) + template


def flow_flops(h: int, w: int, n_pairs: int, preset: str = "fastest",
               search: int = 5, radius: int = 3) -> float:
    """Block-matching flow (``kernels/flow.py``, kernel A), fast presets: one
    level at h/pool × w/pool, S² shift candidates; a pixel and candidate cost
    diff+square (2), the separable box sum (2·(2r+1)+1) and the online
    soft-argmin (~14)."""
    pool = {"accurate": 1, "fast": 2, "fastest": 4}[preset]
    hp, wp = h // pool, w // pool
    s2 = (2 * search + 1) ** 2
    per_px_cand = 2 + (2 * (2 * radius + 1) + 1) + 14
    return float(n_pairs) * hp * wp * s2 * per_px_cand


def iou_matrix_flops(n: int, m: int) -> float:
    """Pairwise IoU (``geometry/boxes.py``): ~12 arithmetic ops a pair."""
    return 12.0 * n * m


def nms_grouped_flops(t: int, group: int, iters: int = 8) -> float:
    """Grouped NMS fixpoint (kernel B): the adjacency's IoU once + ~iters
    sweeps of mask and compare work over the G×G adjacency."""
    return t * (iou_matrix_flops(group, group) + iters * 3.0 * group * group)


def seq_nms_flops(t: int, n: int, classes: int, max_paths: int) -> float:
    """Seq-NMS (``kernels/seq_nms.py``): per class and path, the forward DP
    over (T-1)·N² edges (~4 ops) and the per-frame suppression (~3·N a
    frame); the adjacency's IoU once a class."""
    adj = (t - 1) * iou_matrix_flops(n, n)
    per_round = (t - 1) * 4.0 * n * n + t * 3.0 * n
    return classes * (adj + max_paths * per_round)


def rescore_flops(t: int, k: int, n: int, c: int) -> float:
    """``rescore_arrays``: (T,K,N) IoU + masked max over dets a class + sort."""
    return t * k * iou_matrix_flops(1, n) + 2.0 * t * k * n * c


def fused_dispatch_flops(det_cfg, trk_cfg, fused_cfg, t: int, n_rois: int,
                         videos: int = 1) -> list[ComponentFlops]:
    """Per-component FLOPs of one fused-pipeline call over ``videos`` videos
    of T frames and R proposals a frame (``bench.py``'s shapes)."""
    h, w = fused_cfg.image_hw
    c = det_cfg.num_classes
    t_trk = -(-t // fused_cfg.track_stride)
    comps = [
        ComponentFlops(x.name, t * x.flops, x.unit, f"{t} frames {x.note}" if i == 0 else x.note)
        for i, x in enumerate(detect_flops(det_cfg, h, w, n_rois))
    ] + [
        ComponentFlops("track/features", t_trk * tracker_feat_flops(trk_cfg, h, w), MATMUL,
                       f"dense tracker conv features, every {fused_cfg.track_stride}-th frame"
                       if fused_cfg.track_stride > 1
                       else "dense tracker conv features, all frames"),
        ComponentFlops("track/ncc_scan",
                       tracker_scan_flops(trk_cfg, h, w, t_trk, fused_cfg.anchors_per_round),
                       MATMUL, f"{2 * fused_cfg.anchors_per_round} lanes x {t_trk} steps"),
        ComponentFlops("mgp/flow", flow_flops(h, w, 2 * (t - 1), preset=fused_cfg.flow_preset),
                       SIMT, f"preset={fused_cfg.flow_preset}, fwd+bwd pairs"),
        ComponentFlops("mgp/nms_grouped",
                       nms_grouped_flops(t, fused_cfg.det_budget * (2 * fused_cfg.mgp_window + 1)),
                       SIMT, "post-MGP per-frame per-class dedup"),
        ComponentFlops("rescore", rescore_flops(t, fused_cfg.max_tracks, fused_cfg.out_budget, c),
                       SIMT, ""),
        ComponentFlops("seq_nms", seq_nms_flops(t, fused_cfg.out_budget, c - 1,
                                                fused_cfg.max_paths),
                       SIMT, f"{c - 1} classes x {fused_cfg.max_paths} paths"),
    ]
    if videos != 1:
        comps = [ComponentFlops(x.name, x.flops * videos, x.unit, x.note) for x in comps]
    return comps


def total_flops(comps: list[ComponentFlops]) -> float:
    return sum(x.flops for x in comps)


def mfu(flops: float, seconds: float, peak: float = PEAK_BF16_FLOPS) -> float:
    return flops / (seconds * peak)
