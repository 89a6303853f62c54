"""The folded forward+backward tracker scan: kernel F and its plain version.

Counterpart of ``vdetlib_tpu/kernels/track_pallas.py::track_scan_pallas``.
A anchors are tracked in both directions over T frames of tracker features:
scan step i advances the forward lane of every anchor at frame i and its
backward lane at frame T-1-i. Each lane's step is one :func:`ncc_update`
(search window, bf16 ROI-align of the window, normalized cross-correlation
with the anchor's template, soft-argmax) and the self-gated update: a lane
starts at its anchor frame (anchor box, conf 1), tracks while its peak stays
above ``conf_thresh`` and keeps its last box once it dies.

:func:`track_scan_plain` is the plain version (a Python loop of T steps of
tensor ops over all 2A lanes); :func:`track_scan_kernel` is the wrapper: CPU
tensors go through the plain version, CUDA tensors through
``csrc/track_scan.cu`` (one launch for the whole scan, each lane on a
cluster of :func:`cluster_ctas` blocks, keeping :func:`launch_parts`
partial responses). Both return
``(fb, fc, fa, bb, bc, ba)``: forward and backward boxes (T, A, 4), conf
(T, A) and alive (T, A), indexed by frame, as the JAX kernel does.
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.kernels import build
from vdetlib_tpu_torch.nn.heads import roi_align
from vdetlib_tpu_torch.nn.tracker_net import (
    TrackerConfig,
    correlate,
    search_window,
    soft_argmax_2d,
)

SMEM_LIMIT = 232448  # bytes of dynamic shared memory one block may use on an H100
MAX_CLUSTER = 4  # blocks that share one lane's steps


def ncc_update(feat_t, box, template, cfg: TrackerConfig):
    """One NCC tracking update per lane (no alive logic).

    Args:
      feat_t: (G, h, w, C) features of the target frame of each lane group.
      box: (G, L, 4) current boxes; template: (G, L, P, P, C) normalized.
    Returns:
      (new box candidates (G, L, 4), peak confidences (G, L)).
    """
    Q = cfg.search_pool
    P = cfg.template_pool
    R = Q - P + 1
    S = max(int(cfg.num_scales), 1)
    scales = [cfg.scale_step ** (s - (S - 1) / 2.0) for s in range(S)]
    G, L = box.shape[:2]
    cx = 0.5 * (box[..., 0] + box[..., 2])
    cy = 0.5 * (box[..., 1] + box[..., 3])
    sboxes = []
    for sc in scales:  # box resized by sc around its center
        w = (box[..., 2] - box[..., 0]) * sc
        h = (box[..., 3] - box[..., 1]) * sc
        sboxes.append(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1))
    sbox = torch.stack(sboxes, dim=2)  # (G, L, S, 4)
    win = search_window(sbox, cfg.search_factor)
    # bf16 pooling, as the JAX scan does (NCC peaks are smooth enough)
    sfeat = roi_align(
        feat_t, win.reshape(G, L * S, 4), stride=cfg.stride, pool=Q,
        compute_dtype=torch.bfloat16,
    ).reshape(G, L, S, Q, Q, -1)
    tpl = template[:, :, None].expand((G, L, S) + template.shape[-3:])
    resp = correlate(tpl, sfeat)  # (G, L, S, R, R)
    py, px, peak = soft_argmax_2d(resp)
    wx = (win[..., 2] - win[..., 0]) / Q
    wy = (win[..., 3] - win[..., 1]) / Q
    dx = (px - (R - 1) / 2.0) * wx
    dy = (py - (R - 1) / 2.0) * wy
    cand = sbox + torch.stack([dx, dy, dx, dy], dim=-1)  # (G, L, S, 4)
    if S == 1:
        return cand[:, :, 0], peak[:, :, 0]
    penalty = torch.tensor(
        [1.0 if abs(sc - 1.0) < 1e-6 else cfg.scale_penalty for sc in scales],
        dtype=torch.float32, device=box.device,
    )
    best = torch.argmax(peak * penalty, dim=-1, keepdim=True)  # first maximum
    peak = torch.gather(peak, 2, best)[..., 0]
    raw = torch.gather(cand, 2, best[..., None].expand(G, L, 1, 4))[:, :, 0]
    # damp the scale change: winner's position, blended size
    d = cfg.scale_damping
    rcx = 0.5 * (raw[..., 0] + raw[..., 2])
    rcy = 0.5 * (raw[..., 1] + raw[..., 3])
    rw = (raw[..., 2] - raw[..., 0]) * d + (box[..., 2] - box[..., 0]) * (1 - d)
    rh = (raw[..., 3] - raw[..., 1]) * d + (box[..., 3] - box[..., 1]) * (1 - d)
    new_box = torch.stack([rcx - rw / 2, rcy - rh / 2, rcx + rw / 2, rcy + rh / 2], -1)
    return new_box, peak


def track_scan_plain(feats, anchor_ts, anchor_boxes, templates, cfg: TrackerConfig,
                     conf_thresh: float):
    """The folded scan as a fixed-trip loop of T steps over 2A lanes.

    Args:
      feats: (T, h, w, C) tracker features; anchor_ts: (A,) int frame of each
        anchor; anchor_boxes: (A, 4); templates: (A, P, P, C) normalized.
    Returns:
      (fb, fc, fa, bb, bc, ba), each indexed by frame: (T, A, 4) boxes,
      (T, A) conf, (T, A) alive of the forward and the backward lanes.
    """
    T = feats.shape[0]
    dev = feats.device
    A = anchor_ts.shape[0]
    tpl2 = templates[None].expand((2,) + templates.shape)
    ar = torch.arange(T, device=dev)
    ts_all = torch.stack([ar, ar.flip(0)], dim=1)  # step i → frames (i, T-1-i)
    box_st = torch.zeros((2, A, 4), dtype=torch.float32, device=dev)
    alive_st = torch.zeros((2, A), dtype=torch.bool, device=dev)
    out_b, out_c, out_a = [], [], []
    for i in range(T):
        ts2 = ts_all[i]
        started = ts2[:, None] == anchor_ts[None, :]  # (2, A)
        box = torch.where(started[..., None], anchor_boxes[None], box_st)
        alive2 = alive_st | started
        feat2 = torch.stack([feats[i], feats[T - 1 - i]])
        new_box, peak = ncc_update(feat2, box, tpl2, cfg)
        track_now = alive2 & (ts2[:, None] != anchor_ts[None, :])
        ok = peak > conf_thresh
        new_alive = torch.where(track_now, alive2 & ok, alive2)
        new_box = torch.where((track_now & ok)[..., None], new_box, box)
        out_b.append(new_box)
        out_c.append(torch.where(started, torch.ones_like(peak), peak))
        out_a.append(started | new_alive)
        box_st, alive_st = new_box, new_alive
    # step axis: forward outputs are at frame i, backward outputs at T-1-i
    ob, oc, oa = torch.stack(out_b, 1), torch.stack(out_c, 1), torch.stack(out_a, 1)  # (2, T, A, ...)
    return ob[0], oc[0], oa[0], ob[1].flip(0), oc[1].flip(0), oa[1].flip(0)


def kernel_takes(cfg: TrackerConfig) -> bool:
    """Whether ``cfg`` is kernel F's contract, the JAX package's gate for its
    Pallas scan: one scale and frozen templates (any pools)."""
    return int(cfg.num_scales) <= 1 and cfg.template_eta == 0.0


def _smem_bytes(Q: int, P: int, C: int, bf16: bool, parts: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/track_scan.cu::smem_bytes``
    lays it out: the pooled window in the features' type (16-byte aligned),
    then in float32 the template, ``parts`` partial responses, the row sums
    of the bins' norms and the bins' norms."""
    R = Q - P + 1
    window = -(-Q * Q * C * (2 if bf16 else 4) // 16) * 16
    return window + 4 * (P * P * C + parts * R * R + Q * R + Q * Q)


def cluster_ctas(A: int, sms: int) -> int:
    """Blocks (a thread-block cluster) the kernel spreads each of its 2A lanes
    over: MAX_CLUSTER, halved until every lane's cluster fits the card's
    ``sms`` streaming multiprocessors at once."""
    n = MAX_CLUSTER
    while n > 1 and 2 * A * n > sms:
        n //= 2
    return n


def launch_parts(Q: int, P: int, C: int, bf16: bool) -> int:
    """The partial responses the kernel keeps: one per template row where
    they fit a block's shared memory, else one; raises
    ValueError where neither fits."""
    for parts in (P, 1):
        if _smem_bytes(Q, P, C, bf16, parts) <= SMEM_LIMIT:
            return parts
    raise ValueError(f"track_scan: a {Q}x{Q}x{C} window and a {P}x{P}x{C} template do not "
                     f"fit one block's shared memory")


def track_scan_kernel(feats, anchor_ts, anchor_boxes, templates, cfg: TrackerConfig,
                      conf_thresh: float):
    """The folded scan: plain version on the CPU, kernel F on the card.

    CUDA tensors launch the kernel once for all T steps
    (``track_scan_kernel.launches`` counts the launches) or raise; nothing
    falls back to the plain version."""
    if feats.device.type == "cpu":
        return track_scan_plain(feats, anchor_ts, anchor_boxes, templates, cfg, conf_thresh)
    if feats.device.type != "cuda" or any(
            t.device != feats.device for t in (anchor_ts, anchor_boxes, templates)):
        raise ValueError("track_scan: all tensors must be on one CUDA device")
    if not kernel_takes(cfg):
        raise ValueError(f"track_scan kernel takes num_scales <= 1 and template_eta 0; got {cfg}")
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"track_scan takes bf16 or float32 features, got {feats.dtype}")
    if feats.dim() != 4:
        raise ValueError(f"track_scan takes (T, h, w, C) features, got {tuple(feats.shape)}")
    T, h, w, C = feats.shape
    A = anchor_ts.shape[0]
    Q, P = cfg.search_pool, cfg.template_pool
    if templates.shape != (A, P, P, C) or anchor_boxes.shape != (A, 4):
        raise ValueError(
            f"track_scan: templates {tuple(templates.shape)} and anchor boxes "
            f"{tuple(anchor_boxes.shape)} do not match A={A}, P={P}, C={C}"
        )
    if not 1 <= P <= Q:
        raise ValueError(f"track_scan takes 1 <= template_pool <= search_pool, got P={P}, Q={Q}")
    parts = launch_parts(Q, P, C, feats.dtype == torch.bfloat16)
    if min(T, h, w, C, A) < 1:
        raise ValueError(f"track_scan: empty input {tuple(feats.shape)}, A={A}")
    dev = feats.device
    n_cta = cluster_ctas(A, torch.cuda.get_device_properties(dev).multi_processor_count)
    feats = feats.contiguous()
    ats = anchor_ts.to(torch.int32).contiguous()
    aboxes = anchor_boxes.to(torch.float32).contiguous()
    tpls = templates.to(torch.float32).contiguous()
    out_box = torch.empty((2, T, A, 4), dtype=torch.float32, device=dev)
    out_conf = torch.empty((2, T, A), dtype=torch.float32, device=dev)
    out_alive = torch.empty((2, T, A), dtype=torch.bool, device=dev)
    fn = build.load("track_scan")
    rc = fn(
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), ats.data_ptr(), aboxes.data_ptr(),
        tpls.data_ptr(), out_box.data_ptr(), out_conf.data_ptr(), out_alive.data_ptr(),
        T, A, h, w, C, Q, P, cfg.stride, float(cfg.search_factor), float(conf_thresh),
        n_cta, parts, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch("track_scan", rc)
    track_scan_kernel.launches += 1
    return out_box[0], out_conf[0], out_alive[0], out_box[1], out_conf[1], out_alive[1]


track_scan_kernel.launches = 0
