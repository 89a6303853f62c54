"""Host-side frame loading — the port's copy of ``vdetlib_tpu/data/loader.py``'s
``load_frame``, ``FrameLoader`` (with ``iter_batches``) and
``batch_frames_from_array``: threaded JPEG decode (BGR uint8, the
reference's ``cv2.imread`` convention) with an optional resize to the
detector's static shape, or frames served from memory. ``cv2`` is imported only when an image is read, so
the package imports on a machine without it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from vdetlib_tpu_torch.protos.accessors import frame_path_at


def load_frame(path: str, target_hw: Optional[tuple[int, int]] = None):
    """Read one frame (BGR uint8), optionally resized to (H, W).

    Returns (frame, (scale_y, scale_x)) mapping original → resized coords."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    h, w = img.shape[:2]
    if target_hw is None or (h, w) == tuple(target_hw):
        return img, (1.0, 1.0)
    th, tw = target_hw
    interp = cv2.INTER_AREA if (th < h or tw < w) else cv2.INTER_LINEAR
    out = cv2.resize(img, (tw, th), interpolation=interp)
    return out, (th / h, tw / w)


class FrameLoader:
    """Threaded prefetching loader over a vid_proto's frames.

    ``frames`` (T, H, W, 3) uint8, one per vid_proto frame, serves the frames
    from memory instead of their files: they must already be at
    ``target_hw`` (there is no host resize for them)."""

    def __init__(self, vid_proto: dict, target_hw: Optional[tuple[int, int]] = None,
                 num_threads: int = 8, frames: Optional[np.ndarray] = None):
        self.vid_proto = vid_proto
        self.target_hw = target_hw
        self.frame_ids = [f["frame"] for f in vid_proto["frames"]]
        if frames is not None:
            if len(frames) != len(self.frame_ids):
                raise ValueError(f"{len(frames)} in-memory frames for {len(self.frame_ids)} "
                                 f"vid_proto frames")
            if target_hw is not None and tuple(frames.shape[1:3]) != tuple(target_hw):
                raise ValueError(f"in-memory frames are {tuple(frames.shape[1:3])}, not "
                                 f"{tuple(target_hw)}")
        self.frames = frames
        self._pool = ThreadPoolExecutor(max_workers=num_threads)

    def __len__(self):
        return len(self.frame_ids)

    def iter_frames(self) -> Iterator[tuple[int, np.ndarray, tuple[float, float]]]:
        if self.frames is not None:
            for fid, img in zip(self.frame_ids, self.frames):
                yield fid, img, (1.0, 1.0)
            return
        paths = [frame_path_at(self.vid_proto, f) for f in self.frame_ids]
        futures = [self._pool.submit(load_frame, p, self.target_hw) for p in paths]
        for fid, fut in zip(self.frame_ids, futures):
            img, scale = fut.result()
            yield fid, img, scale

    def iter_batches(self, batch_size: int
                     ) -> Iterator[tuple[list[int], np.ndarray, list[tuple[float, float]]]]:
        """Yield (frame_ids, uint8 (B, H, W, 3), scales); the last batch is
        padded by repeating its final frame so shapes stay static."""
        ids, imgs, scales = [], [], []
        for fid, img, scale in self.iter_frames():
            ids.append(fid)
            imgs.append(img)
            scales.append(scale)
            if len(ids) == batch_size:
                yield ids, np.stack(imgs), scales
                ids, imgs, scales = [], [], []
        if ids:
            imgs = imgs + [imgs[-1]] * (batch_size - len(ids))
            yield ids, np.stack(imgs), scales

    def close(self):
        self._pool.shutdown(wait=False)


def batch_frames_from_array(frames: np.ndarray, batch_size: int
                            ) -> Iterator[tuple[list[int], np.ndarray]]:
    """Batch an in-memory (T, H, W, 3) array; pads the tail by repetition."""
    T = frames.shape[0]
    for start in range(0, T, batch_size):
        idx = list(range(start, min(start + batch_size, T)))
        batch = frames[idx]
        if len(idx) < batch_size:
            pad = np.repeat(batch[-1:], batch_size - len(idx), axis=0)
            batch = np.concatenate([batch, pad], axis=0)
        yield idx, batch
