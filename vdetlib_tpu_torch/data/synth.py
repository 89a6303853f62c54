"""Synthetic video snippets and protos, for tests, the smoke run and demos.

The port's own copy of ``vdetlib_tpu/data/synth.py``: textured rectangles
moving linearly (bouncing off the edges) over a static noise background,
with ground-truth boxes, proposals (``box_proto``) and a plausible detector
output (``det_proto_from_gt``). Same names, same seeded streams, so frames,
boxes, visibility and distractor arrays are bit-identical to the JAX
package's for the same :class:`SynthConfig`.

Two tiers: the easy one (every hard knob at its default) and the hard one
(:func:`hard_config`: crossing paths, camouflaged occluders, flickering
class-coloured distractors, camera pan and jitter, appearance drift, lower
contrast), which the EMA-template tests use. ``det_proto_from_gt``'s
flicker-regime false positives (``distractor_fp_rate``) are not copied.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SynthConfig:
    num_frames: int = 30
    height: int = 240
    width: int = 320
    num_objects: int = 3
    num_classes: int = 4  # including background index 0
    seed: int = 0
    min_size: int = 30
    max_size: int = 80
    max_speed: float = 4.0
    proposals_per_frame: int = 24
    jitter: float = 3.0
    scale_rate: float = 0.0  # per-frame relative size change (e.g. 0.02)
    # tie object appearance (colour/texture) to the class label
    class_coded_appearance: bool = False
    # ---- hard-tier knobs (all defaults off → easy-tier pixels unchanged) --
    camera_pan_amp: float = 0.0  # px amplitude of sinusoidal camera pan
    camera_jitter: float = 0.0  # px stddev of per-frame camera shake
    num_occluders: int = 0  # camouflaged moving bars drawn OVER objects
    occluder_speed: float = 6.0  # px/frame along the bar's sweep axis
    occluder_width_frac: float = 0.22  # bar thickness as a fraction of W/H
    num_distractors: int = 0  # flickering class-colored non-objects (no GT)
    distractor_on: tuple = (2, 6)  # on-window length range (frames)
    distractor_off: tuple = (4, 10)  # off-window length range (frames)
    appearance_drift: float = 0.0  # ±fraction of per-object gain drift
    crossing_paths: bool = False  # object endpoints permuted → paths cross
    contrast: float = 1.0  # object/background color separation scale

    @property
    def is_hard(self) -> bool:
        return (
            self.camera_pan_amp > 0
            or self.camera_jitter > 0
            or self.num_occluders > 0
            or self.num_distractors > 0
            or self.appearance_drift > 0
            or self.crossing_paths
            or self.contrast != 1.0
        )


def hard_config(**overrides) -> SynthConfig:
    """The hard-tier preset, as the JAX package's: every failure mode the
    temporal stages are built to fix."""
    base = dict(
        num_objects=4,
        class_coded_appearance=True,
        crossing_paths=True,
        camera_pan_amp=12.0,
        camera_jitter=2.0,
        num_occluders=2,
        num_distractors=3,
        appearance_drift=0.35,
        contrast=0.6,
    )
    base.update(overrides)
    return SynthConfig(**base)


@dataclass
class SynthVideo:
    config: SynthConfig
    frames: np.ndarray  # (T, H, W, 3) uint8, BGR
    gt_boxes: np.ndarray  # (K, T, 4) float32
    gt_classes: np.ndarray  # (K,) int32 in [1, num_classes)
    video: str = "synth"
    frame_ids: list = field(default_factory=list)
    # (K, T) bool — False where the object is out of the camera view (hard
    # tier); full occlusion by an occluder does NOT clear it (the object is
    # still annotated — the temporal stages must bridge the blind window).
    gt_visible: np.ndarray = None
    # (K, T) float in [0, 1] — largest fraction of the box covered by an
    # occluder bar or a later-drawn object (hard tier). Training uses it to
    # skip evidence-free labels; eval does NOT (occluded objects count).
    gt_occluded: np.ndarray = None
    # (D, T, 4) view-space boxes of the flickering distractors + (D, T) bool
    # on-schedule (hard tier; None on the easy tier). NOT ground truth: the
    # JAX package's distractor-aware tracker training mines them
    distractor_boxes: np.ndarray = None
    distractor_on: np.ndarray = None
    # (D,) int32 — the class whose appearance each distractor mimics
    distractor_classes: np.ndarray = None

    def __post_init__(self):
        if not self.frame_ids:
            self.frame_ids = list(range(1, self.frames.shape[0] + 1))
        if self.gt_visible is None:
            self.gt_visible = np.ones(self.gt_boxes.shape[:2], dtype=bool)
        if self.gt_occluded is None:
            self.gt_occluded = np.zeros(self.gt_boxes.shape[:2], np.float32)


def make_video(cfg: SynthConfig, video: str = "synth") -> SynthVideo:
    if cfg.is_hard:
        return _make_video_hard(cfg, video)
    rng = np.random.default_rng(cfg.seed)
    T, H, W, K = cfg.num_frames, cfg.height, cfg.width, cfg.num_objects
    # static textured background: flow and tracking rely on it not changing
    background = rng.integers(20, 60, size=(H, W, 3), dtype=np.uint8)
    frames = np.repeat(background[None], T, axis=0).copy()

    sizes = rng.uniform(cfg.min_size, cfg.max_size, size=(K, 2))
    pos0 = np.stack(
        [rng.uniform(0, W - sizes[:, 0]), rng.uniform(0, H - sizes[:, 1])], axis=1
    )
    vel = rng.uniform(-cfg.max_speed, cfg.max_speed, size=(K, 2))
    classes = rng.integers(1, cfg.num_classes, size=K).astype(np.int32)
    if cfg.class_coded_appearance:
        # class-seeded palette + texture with small per-object jitter
        colors = np.zeros((K, 3), np.uint8)
        textures = np.zeros((K, 16, 16, 3), np.int16)
        for k in range(K):
            c = int(classes[k])
            crng = np.random.default_rng(1000 + c)
            base = crng.integers(40, 90, size=3)
            base[c % 3] = 200 + crng.integers(0, 50)
            tex = crng.integers(-35, 35, size=(16, 16, 3))
            colors[k] = np.clip(base + rng.integers(-10, 11, size=3), 0, 255)
            textures[k] = tex + rng.integers(-6, 7, size=(16, 16, 3))
    else:
        colors = rng.integers(100, 255, size=(K, 3)).astype(np.uint8)
        # per-object texture so the correlation tracker has structure
        textures = rng.integers(-40, 40, size=(K, 16, 16, 3)).astype(np.int16)

    gt = np.zeros((K, T, 4), dtype=np.float32)
    for t in range(T):
        for k in range(K):
            x = pos0[k, 0] + vel[k, 0] * t
            y = pos0[k, 1] + vel[k, 1] * t
            grow = (1.0 + cfg.scale_rate) ** t
            w = min(sizes[k, 0] * grow, W * 0.6)
            h = min(sizes[k, 1] * grow, H * 0.6)
            x = _bounce(x, W - w)
            y = _bounce(y, H - h)
            x1, y1, x2, y2 = x, y, x + w - 1, y + h - 1
            gt[k, t] = (x1, y1, x2, y2)
            xi1, yi1 = int(round(x1)), int(round(y1))
            xi2, yi2 = int(round(x2)) + 1, int(round(y2)) + 1
            patch = frames[t, yi1:yi2, xi1:xi2].astype(np.int16)
            ph, pw = patch.shape[:2]
            if ph <= 0 or pw <= 0:
                continue
            tex = np.kron(
                textures[k], np.ones((max(1, ph // 16 + 1), max(1, pw // 16 + 1), 1), np.int16)
            )[:ph, :pw]
            filled = colors[k][None, None, :].astype(np.int16) + tex
            frames[t, yi1:yi2, xi1:xi2] = np.clip(filled, 0, 255).astype(np.uint8)
    return SynthVideo(config=cfg, frames=frames, gt_boxes=gt, gt_classes=classes, video=video)


def _bounce(x: float, limit: float) -> float:
    if limit <= 0:
        return 0.0
    period = 2 * limit
    x = x % period
    return period - x if x > limit else x


def _class_appearance(c: int, rng, contrast: float = 1.0):
    """Class-seeded (color, texture) with per-object jitter from ``rng``.

    ``contrast`` < 1 pulls the palette toward the background mean (~40) and
    damps the texture — the hard tier's low-contrast knob.
    """
    crng = np.random.default_rng(1000 + int(c))
    base = crng.integers(40, 90, size=3)
    base[int(c) % 3] = 200 + crng.integers(0, 50)
    tex = crng.integers(-35, 35, size=(16, 16, 3))
    color = base + rng.integers(-10, 11, size=3)
    color = 40.0 + (color - 40.0) * contrast
    tex = (tex + rng.integers(-6, 7, size=(16, 16, 3))) * contrast
    return np.clip(color, 0, 255).astype(np.uint8), tex.astype(np.int16)


def _draw_rect(canvas, x1, y1, x2, y2, color, texture, gain: float = 1.0):
    """Fill an axis-aligned box with color+tiled texture (the object look)."""
    H, W = canvas.shape[:2]
    xi1, yi1 = int(round(x1)), int(round(y1))
    xi2, yi2 = int(round(x2)) + 1, int(round(y2)) + 1
    xi1, yi1 = max(xi1, 0), max(yi1, 0)
    xi2, yi2 = min(xi2, W), min(yi2, H)
    ph, pw = yi2 - yi1, xi2 - xi1
    if ph <= 0 or pw <= 0:
        return
    tex = np.kron(
        texture, np.ones((max(1, ph // 16 + 1), max(1, pw // 16 + 1), 1), np.int16)
    )[:ph, :pw]
    filled = color[None, None, :].astype(np.float64) * gain + tex
    canvas[yi1:yi2, xi1:xi2] = np.clip(filled, 0, 255).astype(np.uint8)


def _flicker_schedule(rng, T: int, on_range, off_range) -> np.ndarray:
    """(T,) bool on/off schedule of alternating random-length windows."""
    on = np.zeros(T, dtype=bool)
    t = int(rng.integers(0, max(off_range[0], 1) + 1))
    state = True
    while t < T:
        lo, hi = on_range if state else off_range
        span = int(rng.integers(lo, hi + 1))
        if state:
            on[t : t + span] = True
        t += span
        state = not state
    return on


def _make_video_hard(cfg: SynthConfig, video: str = "synth") -> SynthVideo:
    """The hard tier: world canvas + camera crop, occluders, distractors.

    Draw order per frame (world coords): background → distractors (below
    objects) → objects (ascending index; later objects occlude earlier ones
    at path crossings) → occluder bars (over everything). The camera window
    then crops the view; ground truth is view-space, marked invisible when
    mostly out of frame.
    """
    rng = np.random.default_rng(cfg.seed)
    T, H, W, K = cfg.num_frames, cfg.height, cfg.width, cfg.num_objects
    m = int(np.ceil(cfg.camera_pan_amp + 3.0 * cfg.camera_jitter))
    world = rng.integers(20, 60, size=(H + 2 * m, W + 2 * m, 3), dtype=np.uint8)

    sizes = rng.uniform(cfg.min_size, cfg.max_size, size=(K, 2))
    pos0 = np.stack(
        [rng.uniform(0, W - sizes[:, 0]), rng.uniform(0, H - sizes[:, 1])],
        axis=1,
    )
    if cfg.crossing_paths and K >= 2:
        # endpoints are a cyclic shift of the start points (+ noise): every
        # object's path crosses at least one other's near mid-video
        pos1 = np.roll(pos0, 1, axis=0) + rng.normal(0, 8.0, size=(K, 2))
        vel = (pos1 - pos0) / max(T - 1, 1)
    else:
        vel = rng.uniform(-cfg.max_speed, cfg.max_speed, size=(K, 2))
    classes = rng.integers(1, cfg.num_classes, size=K).astype(np.int32)

    colors = np.zeros((K, 3), np.uint8)
    textures = np.zeros((K, 16, 16, 3), np.int16)
    for k in range(K):
        if cfg.class_coded_appearance:
            colors[k], textures[k] = _class_appearance(
                classes[k], rng, cfg.contrast
            )
        else:
            c = rng.integers(100, 255, size=3).astype(np.float64)
            colors[k] = np.clip(40.0 + (c - 40.0) * cfg.contrast, 0, 255)
            textures[k] = (
                rng.integers(-40, 40, size=(16, 16, 3)) * cfg.contrast
            ).astype(np.int16)

    # appearance drift: slow per-object sinusoidal gain
    drift_freq = rng.uniform(0.5, 1.5, size=K)
    drift_phase = rng.uniform(0, 2 * np.pi, size=K)

    # camera path: sinusoidal pan + white jitter, in [-m, m] around center
    phx, phy = rng.uniform(0, 2 * np.pi, size=2)
    fx, fy = rng.uniform(0.5, 1.5, size=2)
    tt = np.arange(T) / max(T - 1, 1)
    cam = np.stack(
        [
            cfg.camera_pan_amp * np.sin(2 * np.pi * fx * tt + phx),
            cfg.camera_pan_amp * np.sin(2 * np.pi * fy * tt + phy),
        ],
        axis=1,
    )
    if cfg.camera_jitter > 0:
        cam = cam + rng.normal(0, cfg.camera_jitter, size=(T, 2))
    cam = np.clip(np.round(cam).astype(int), -m, m)  # (T, 2) = (dx, dy)

    # occluders: camouflaged bars sweeping the world along one axis
    occ = []
    for _ in range(cfg.num_occluders):
        horizontal = bool(rng.integers(0, 2))
        thick = cfg.occluder_width_frac * (H if horizontal else W)
        speed = cfg.occluder_speed * (1 if rng.integers(0, 2) else -1)
        start = rng.uniform(0, (H if horizontal else W))
        color = rng.integers(20, 60, size=3).astype(np.uint8)
        tex = rng.integers(-20, 20, size=(16, 16, 3)).astype(np.int16)
        occ.append((horizontal, thick, speed, start, color, tex))

    # distractors: class-colored flickering non-objects
    dis = []
    for _ in range(cfg.num_distractors):
        dsz = rng.uniform(cfg.min_size, cfg.max_size, size=2)
        dp0 = np.array(
            [rng.uniform(0, W - dsz[0]), rng.uniform(0, H - dsz[1])]
        )
        dv = rng.uniform(-cfg.max_speed, cfg.max_speed, size=2)
        dc = int(rng.integers(1, cfg.num_classes))
        if cfg.class_coded_appearance:
            dcol, dtex = _class_appearance(dc, rng, cfg.contrast)
        else:
            c = rng.integers(100, 255, size=3).astype(np.float64)
            dcol = np.clip(40.0 + (c - 40.0) * cfg.contrast, 0, 255).astype(
                np.uint8
            )
            dtex = (
                rng.integers(-40, 40, size=(16, 16, 3)) * cfg.contrast
            ).astype(np.int16)
        on = _flicker_schedule(rng, T, cfg.distractor_on, cfg.distractor_off)
        dis.append((dsz, dp0, dv, dcol, dtex, on, dc))

    def _cover_frac(box, cover):
        """Fraction of ``box`` (x1,y1,x2,y2 view coords) covered by ``cover``."""
        ix1 = max(box[0], cover[0])
        iy1 = max(box[1], cover[1])
        ix2 = min(box[2], cover[2])
        iy2 = min(box[3], cover[3])
        inter = max(ix2 - ix1 + 1, 0.0) * max(iy2 - iy1 + 1, 0.0)
        area = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
        return inter / max(area, 1.0)

    frames = np.zeros((T, H, W, 3), np.uint8)
    gt = np.zeros((K, T, 4), np.float32)
    visible = np.zeros((K, T), bool)
    occluded = np.zeros((K, T), np.float32)
    D = len(dis)
    dis_boxes = np.zeros((D, T, 4), np.float32)
    dis_on = np.zeros((D, T), bool)
    dis_cls = np.asarray([d[-1] for d in dis], np.int32)
    for t in range(T):
        canvas = world.copy()
        for d, (dsz, dp0, dv, dcol, dtex, on, _dc) in enumerate(dis):
            x = _bounce(dp0[0] + dv[0] * t, W - dsz[0])
            y = _bounce(dp0[1] + dv[1] * t, H - dsz[1])
            # view-space box recorded even when flickered off (the sampler
            # cares about spatial proximity; `on` carries the schedule)
            dis_boxes[d, t] = (
                x - cam[t, 0], y - cam[t, 1],
                x + dsz[0] - 1 - cam[t, 0], y + dsz[1] - 1 - cam[t, 1],
            )
            dis_on[d, t] = bool(on[t])
            if not on[t]:
                continue
            _draw_rect(
                canvas, x + m, y + m, x + dsz[0] - 1 + m, y + dsz[1] - 1 + m,
                dcol, dtex,
            )
        obj_view = np.zeros((K, 4))  # unclipped view-space boxes this frame
        for k in range(K):
            grow = (1.0 + cfg.scale_rate) ** t
            w = min(sizes[k, 0] * grow, W * 0.6)
            h = min(sizes[k, 1] * grow, H * 0.6)
            x = _bounce(pos0[k, 0] + vel[k, 0] * t, W - w)
            y = _bounce(pos0[k, 1] + vel[k, 1] * t, H - h)
            gain = 1.0 + cfg.appearance_drift * np.sin(
                2 * np.pi * drift_freq[k] * t / max(T - 1, 1) + drift_phase[k]
            )
            _draw_rect(
                canvas, x + m, y + m, x + w - 1 + m, y + h - 1 + m,
                colors[k], textures[k], gain,
            )
            # view-space ground truth (camera offset), clipped to the frame
            vx1 = x - cam[t, 0]
            vy1 = y - cam[t, 1]
            vx2, vy2 = vx1 + w - 1, vy1 + h - 1
            obj_view[k] = (vx1, vy1, vx2, vy2)
            cx1, cy1 = max(vx1, 0.0), max(vy1, 0.0)
            cx2, cy2 = min(vx2, W - 1.0), min(vy2, H - 1.0)
            inter = max(cx2 - cx1 + 1, 0.0) * max(cy2 - cy1 + 1, 0.0)
            frac = inter / (w * h)
            gt[k, t] = (cx1, cy1, max(cx2, cx1), max(cy2, cy1))
            visible[k, t] = frac >= 0.25
        occ_view = []
        for horizontal, thick, speed, start, ocol, otex in occ:
            span = H if horizontal else W
            p = (start + speed * t) % (span + thick) - thick
            if horizontal:
                _draw_rect(canvas, 0, p + m, W + 2 * m - 1, p + thick + m, ocol, otex)
                occ_view.append(
                    (-1e9, p - cam[t, 1], 1e9, p + thick - cam[t, 1])
                )
            else:
                _draw_rect(canvas, p + m, 0, p + thick + m, H + 2 * m - 1, ocol, otex)
                occ_view.append(
                    (p - cam[t, 0], -1e9, p + thick - cam[t, 0], 1e9)
                )
        for k in range(K):
            covers = [obj_view[j] for j in range(k + 1, K)] + occ_view
            if covers:
                occluded[k, t] = max(
                    _cover_frac(obj_view[k], c) for c in covers
                )
        oy, ox = m + cam[t, 1], m + cam[t, 0]
        frames[t] = canvas[oy : oy + H, ox : ox + W]
    return SynthVideo(
        config=cfg, frames=frames, gt_boxes=gt, gt_classes=classes,
        video=video, gt_visible=visible, gt_occluded=occluded,
        distractor_boxes=dis_boxes, distractor_on=dis_on,
        distractor_classes=dis_cls,
    )


def write_frames(sv: SynthVideo, root: str) -> dict:
    """Write JPEG frames under ``root/<video>/`` and return the vid_proto."""
    import cv2

    frame_dir = os.path.join(root, sv.video)
    os.makedirs(frame_dir, exist_ok=True)
    entries = []
    for i, fid in enumerate(sv.frame_ids):
        rel = os.path.join(sv.video, f"{fid:06d}.jpg")
        cv2.imwrite(os.path.join(root, rel), sv.frames[i])
        entries.append({"frame": int(fid), "path": rel})
    return {"video": sv.video, "root_path": root, "frames": entries}


def vid_proto_in_memory(sv: SynthVideo) -> dict:
    """vid_proto with placeholder paths, for fully in-memory pipelines."""
    return {
        "video": sv.video,
        "root_path": "",
        "frames": [{"frame": int(f), "path": f"{f:06d}.jpg"} for f in sv.frame_ids],
    }


def annot_proto(sv: SynthVideo, class_names=None) -> dict:
    anns = []
    for k in range(sv.gt_boxes.shape[0]):
        track = []
        for t, fid in enumerate(sv.frame_ids):
            if not sv.gt_visible[k, t]:
                continue  # out of the camera view (hard tier) — unannotated
            name = (
                class_names[sv.gt_classes[k]]
                if class_names is not None
                else str(int(sv.gt_classes[k]))
            )
            track.append(
                {
                    "frame": int(fid),
                    "bbox": [float(v) for v in sv.gt_boxes[k, t]],
                    "class": name,
                    "class_index": int(sv.gt_classes[k]),
                }
            )
        if track:
            anns.append({"id": k, "track": track})
    return {"video": sv.video, "annotations": anns}


def box_proto(sv: SynthVideo) -> dict:
    """Proposals: jittered ground truth + uniform random boxes."""
    cfg = sv.config
    rng = np.random.default_rng(cfg.seed + 1)
    K, T = sv.gt_boxes.shape[:2]
    boxes = []
    for t, fid in enumerate(sv.frame_ids):
        for k in range(K):
            if not sv.gt_visible[k, t]:
                continue
            for _ in range(max(1, cfg.proposals_per_frame // (2 * K))):
                jit = rng.normal(0, cfg.jitter, size=4)
                boxes.append({"frame": int(fid), "bbox": _clipped(sv.gt_boxes[k, t] + jit, cfg)})
        n_rand = cfg.proposals_per_frame - len([b for b in boxes if b["frame"] == int(fid)])
        for _ in range(max(0, n_rand)):
            x1 = rng.uniform(0, cfg.width - cfg.min_size)
            y1 = rng.uniform(0, cfg.height - cfg.min_size)
            w = rng.uniform(cfg.min_size, cfg.max_size)
            h = rng.uniform(cfg.min_size, cfg.max_size)
            boxes.append({"frame": int(fid), "bbox": _clipped([x1, y1, x1 + w, y1 + h], cfg)})
    return {"video": sv.video, "boxes": boxes}


def det_proto_from_gt(sv: SynthVideo, dets_per_object: int = 4, distractors_per_frame: int = 6,
                      class_names=None, drop_rate: float = 0.0, dropout_windows: int = 0,
                      dropout_len: tuple = (3, 8)) -> dict:
    """A plausible detector output: jittered GT boxes with decaying scores
    plus low-scoring random distractors. Deterministic given the seed.

    ``drop_rate`` drops per-frame detections i.i.d.; ``dropout_windows``
    blinds the oracle for whole windows per object (``dropout_len`` frames).
    """
    cfg = sv.config
    rng = np.random.default_rng(cfg.seed + 2)
    K, T = sv.gt_boxes.shape[:2]
    detections = []
    dropped = np.zeros((K, T), bool)
    for k in range(K):
        for _ in range(dropout_windows):
            span = int(rng.integers(dropout_len[0], dropout_len[1] + 1))
            t0 = int(rng.integers(0, max(T - span, 1)))
            dropped[k, t0 : t0 + span] = True

    def name(ci):
        return class_names[ci] if class_names is not None else str(int(ci))

    for t, fid in enumerate(sv.frame_ids):
        for k in range(K):
            if not sv.gt_visible[k, t] or sv.gt_occluded[k, t] > 0.5 or dropped[k, t]:
                continue
            if drop_rate > 0 and rng.uniform() < drop_rate:
                continue
            for j in range(dets_per_object):
                jit = rng.normal(0, cfg.jitter * (1 + j), size=4)
                b = _clipped(sv.gt_boxes[k, t] + jit, cfg)
                ci = int(sv.gt_classes[k])
                score = float(np.clip(0.95 - 0.12 * j + rng.normal(0, 0.02), 0.05, 1.0))
                detections.append({
                    "frame": int(fid), "bbox": b,
                    "scores": [{"class": name(ci), "class_index": ci, "score": score}],
                })
        for _ in range(distractors_per_frame):
            x1 = rng.uniform(0, cfg.width - cfg.min_size)
            y1 = rng.uniform(0, cfg.height - cfg.min_size)
            w = rng.uniform(cfg.min_size, cfg.max_size)
            h = rng.uniform(cfg.min_size, cfg.max_size)
            ci = int(rng.integers(1, cfg.num_classes))
            detections.append({
                "frame": int(fid),
                "bbox": _clipped([x1, y1, x1 + w, y1 + h], cfg),
                "scores": [{"class": name(ci), "class_index": ci,
                            "score": float(rng.uniform(0.02, 0.3))}],
            })
    return {"video": sv.video, "detections": detections}


def _clipped(b, cfg: SynthConfig) -> list[float]:
    return [
        float(np.clip(b[0], 0, cfg.width - 1)),
        float(np.clip(b[1], 0, cfg.height - 1)),
        float(np.clip(b[2], 0, cfg.width - 1)),
        float(np.clip(b[3], 0, cfg.height - 1)),
    ]
