"""Seq-NMS tubelet linking — counterpart of ``vdetlib_tpu/kernels/seq_nms.py``.

Repeat {Viterbi max-score path over the frame-adjacency graph (IoU >
link_thresh between consecutive frames) → rescore the path to its
statistic → remove it and suppress per-frame overlaps}. Classes are a batch
axis. :func:`seq_nms_batch` routes a call by its input's own shape:

- CUDA tensors of at most ``MAX_SLOTS`` (64) slots a frame: the CUDA kernel
  G (``csrc/seq_nms.cu``, :func:`seq_nms_kernel`), the whole path loop in
  one launch, a block a class lane, after the IoU tests are packed into
  bit words in torch ops (:func:`link_masks`);
- CPU tensors, and CUDA tensors of more slots (the stream's video-end
  linking, 900): the plain version :func:`seq_nms_plain` in torch ops
  (``seq_nms_batch.plain_calls`` counts the card's calls that take it).

The plain version turns the JAX package's data-dependent loops into
fixed-trip loops with self-gated masked updates, so nothing waits on the
host:

- paths: ``max_paths`` iterations; an iteration whose best path score is
  <= 0 (nothing left, or the budget spent) changes no state, exactly like
  the iterations the JAX ``while_loop`` no longer runs;
- backtrack: ``T`` steps; a lane stops walking where its path ends.

``argmax`` returns the FIRST maximum (as ``jnp.argmax``), so the start of
each path and its backpointers break ties like the reference. Kernel G
decides every link, path and suppression as the plain version does; its
"avg" statistic sums in another order (within 1e-6 relative).
"""

from __future__ import annotations

import torch

from vdetlib_tpu_torch.geometry.boxes import LEGACY_OFFSET, pairwise_iou
from vdetlib_tpu_torch.kernels import build

__all__ = ["MAX_SLOTS", "link_masks", "seq_nms_batch", "seq_nms_kernel",
           "seq_nms_plain", "seq_nms_single"]

NEG = -1e30
MAX_SLOTS = 64  # kernel G: a slot a thread, a frame's alive slots in one 64-bit word


def seq_nms_batch(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                  max_paths: int = 100, rescore: str = "avg", offset: float = LEGACY_OFFSET):
    """Per-class seq-NMS.

    Args:
      boxes: (T, N, 4) shared across classes; scores: (C, T, N); mask: (C, T, N) bool.
    Returns:
      out_scores (C, T, N): path boxes carry the path statistic, suppressed
        boxes -1, untouched boxes their score; path_id (C, T, N) int32, -1 = none.

    CUDA tensors of 1 to ``MAX_SLOTS`` slots launch kernel G; other CUDA
    tensors (counted in ``seq_nms_batch.plain_calls``) and CPU tensors run
    :func:`seq_nms_plain`.
    """
    if scores.device.type == "cuda":
        if 1 <= scores.shape[-1] <= MAX_SLOTS:
            return seq_nms_kernel(boxes.contiguous(), scores.contiguous(), mask.contiguous(),
                                  link_thresh, suppress_thresh, max_paths=max_paths,
                                  rescore=rescore, offset=offset)
        seq_nms_batch.plain_calls += 1
    return seq_nms_plain(boxes, scores, mask, link_thresh, suppress_thresh,
                         max_paths=max_paths, rescore=rescore, offset=offset)


seq_nms_batch.plain_calls = 0


def link_masks(boxes, link_thresh: float, suppress_thresh: float,
               offset: float = LEGACY_OFFSET):
    """Kernel G's IoU tests, packed into int64 bit words → (link, over).

    link (T-1, N): bit i of ``link[t - 1, j]`` is
    ``pairwise_iou(boxes[t - 1], boxes[t])[i, j] > link_thresh`` (the
    predecessors of slot j of frame t); over (T, N): bit j of ``over[t, p]``
    is ``pairwise_iou(boxes[t], boxes[t])[p, j] > suppress_thresh`` (the
    slots of frame t a path through slot p suppresses). One pairwise IoU of
    both, with the plain version's op order and argument order, so each
    decision is the plain version's bit for bit. Needs N <= 64."""
    T, N = boxes.shape[:2]
    iou = pairwise_iou(torch.cat([boxes[:-1], boxes]), torch.cat([boxes[1:], boxes]),
                       offset=offset)  # (2T - 1, N, N): the links, then the overlaps
    bits = torch.ones(N, dtype=torch.int64, device=boxes.device) << torch.arange(
        N, device=boxes.device)  # bit 63 is -2**63: the words add as they OR
    link = torch.where(iou[:T - 1] > link_thresh, bits[:, None], 0).sum(1)
    over = torch.where(iou[T - 1:] > suppress_thresh, bits, 0).sum(2)
    return link, over


def seq_nms_kernel(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                   max_paths: int = 100, rescore: str = "avg", offset: float = LEGACY_OFFSET):
    """:func:`seq_nms_batch` on a card through kernel G, one launch a call
    (``seq_nms_kernel.launches`` counts them) after :func:`link_masks`.

    Takes boxes (T, N, 4) f32, scores (C, T, N) f32 and mask (C, T, N) bool,
    contiguous on one CUDA device, T >= 1 and 1 <= N <= ``MAX_SLOTS``;
    raises otherwise."""
    tensors = (boxes, scores, mask)
    dev = scores.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"seq_nms: tensors on {[str(t.device) for t in tensors]}")
    if scores.dim() != 3 or mask.shape != scores.shape or boxes.shape != scores.shape[1:] + (4,):
        raise ValueError(f"seq_nms kernel takes boxes (T, N, 4), scores and mask (C, T, N); got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(mask.shape)}")
    dtypes = tuple(t.dtype for t in tensors)
    if dtypes != (torch.float32, torch.float32, torch.bool):
        raise TypeError(f"seq_nms kernel takes (f32, f32, bool), got {dtypes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("seq_nms kernel takes contiguous inputs")
    C, T, N = scores.shape
    if T < 1 or not 1 <= N <= MAX_SLOTS or max_paths < 0:
        raise ValueError(f"seq_nms kernel takes T >= 1, 1 <= N <= {MAX_SLOTS} and max_paths >= 0;"
                         f" got T = {T}, N = {N}, max_paths = {max_paths}")
    out = torch.empty((C, T, N), dtype=torch.float32, device=dev)
    path_id = torch.empty((C, T, N), dtype=torch.int32, device=dev)
    if C == 0:
        return out, path_id
    link, over = link_masks(boxes, link_thresh, suppress_thresh, offset)
    # the lanes' state: alive slots as a word a frame, path slots, backpointers
    alive = torch.empty((C, T), dtype=torch.int64, device=dev)
    path = torch.empty((C, T), dtype=torch.int8, device=dev)
    bp = torch.empty((C, T, N), dtype=torch.int8, device=dev)
    rc = build.load("seq_nms")(
        scores.data_ptr(), mask.data_ptr(), link.data_ptr(), over.data_ptr(), out.data_ptr(),
        path_id.data_ptr(), alive.data_ptr(), path.data_ptr(), bp.data_ptr(), C, T, N,
        int(max_paths), int(rescore != "avg"), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch("seq_nms", rc)
    seq_nms_kernel.launches += 1
    return out, path_id


seq_nms_kernel.launches = 0


def seq_nms_plain(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                  max_paths: int = 100, rescore: str = "avg", offset: float = LEGACY_OFFSET):
    """:func:`seq_nms_batch` in torch ops, on any device (its plain version)."""
    Cb, T, N = scores.shape
    dev = scores.device
    neg = scores.new_full((), NEG)
    adj = pairwise_iou(boxes[:-1], boxes[1:], offset=offset) > link_thresh  # (T-1, N, N)
    # one unlinked slab at the end keeps adj[t] indexable at t = 0 when T = 1
    adj = torch.cat([adj, adj.new_zeros((1, N, N))], dim=0)
    lanes = torch.arange(Cb, device=dev)
    alive = mask.clone()
    out_scores = scores * mask
    path_id = torch.full((Cb, T, N), -1, dtype=torch.int32, device=dev)
    n_paths = torch.zeros(Cb, dtype=torch.int32, device=dev)

    def viterbi(alive):
        """Forward DP → dp (C, T, N): best path score ending at each box."""
        s = torch.where(alive, scores, neg)
        dp = [torch.where(alive[:, 0], scores[:, 0], neg)]
        for t in range(1, T):
            # max-plus product over linked, alive predecessors
            cand = torch.where(adj[t - 1][None], dp[-1][:, :, None], neg)  # (C, Nprev, N)
            prev_best = cand.amax(1)
            dp.append(torch.where(alive[:, t], s[:, t] + torch.clamp(prev_best, min=0.0), neg))
        return torch.stack(dp, 1)

    def extract_path(dp):
        """Backtrack each lane's global best path → onehot (C, T, N), best (C,)."""
        flat = torch.argmax(dp.reshape(Cb, T * N), dim=1)
        t = flat // N
        cur = flat % N
        best = dp.reshape(Cb, T * N)[lanes, flat]
        walking = best > 0
        onehot = torch.zeros((Cb, T, N), dtype=torch.bool, device=dev)
        for _ in range(T):
            onehot[lanes, t, cur] |= walking
            tp = torch.clamp(t - 1, min=0)
            col = adj[tp, :, cur]  # (C, N) edges (t-1 → t) into cur
            cand = torch.where(col, dp[lanes, tp], neg)
            nxt = torch.argmax(cand, dim=1)
            ok = walking & (t > 0) & (cand[lanes, nxt] > 0)
            t = tp
            cur = torch.where(ok, nxt, cur)
            walking = ok
        return onehot, best

    for _ in range(max_paths):
        dp = viterbi(alive)
        onehot_raw, best = extract_path(dp)
        active = (best > 0) & (n_paths < max_paths)
        onehot = onehot_raw & alive & active[:, None, None]
        frame_on_path = onehot.any(2)  # (C, T)
        path_scores = torch.where(onehot, scores, torch.zeros_like(scores)).sum(2)
        if rescore == "avg":
            n_on = torch.clamp(frame_on_path.sum(1), min=1)
            stat = torch.where(frame_on_path, path_scores, torch.zeros_like(path_scores)).sum(1) / n_on
        else:
            stat = torch.where(frame_on_path, path_scores, neg).amax(1)
        out_scores = torch.where(onehot, stat[:, None, None], out_scores)
        path_id = torch.where(onehot, n_paths[:, None, None], path_id)
        alive = alive & ~onehot
        # per-frame suppression against the path box
        path_box = torch.where(onehot[..., None], boxes[None], 0.0).sum(2)  # (C, T, 4)
        iou_row = pairwise_iou(path_box[:, :, None, :], boxes[None], offset=offset)[:, :, 0]
        kill = (iou_row > suppress_thresh) & frame_on_path[:, :, None] & alive
        out_scores = torch.where(kill, torch.full_like(out_scores, -1.0), out_scores)
        alive = alive & ~kill
        n_paths = n_paths + active.to(torch.int32)
    return out_scores, path_id


def seq_nms_single(boxes, scores, mask, link_thresh: float, suppress_thresh: float,
                   max_paths: int = 100, rescore: str = "avg", offset: float = LEGACY_OFFSET):
    """Seq-NMS over one class: scores/mask (T, N) → out_scores, path_id (T, N)."""
    out, pid = seq_nms_batch(boxes, scores[None], mask[None], link_thresh, suppress_thresh,
                             max_paths=max_paths, rescore=rescore, offset=offset)
    return out[0], pid[0]
