"""Generate a vid_proto from a directory of frame images.

Counterpart of ``python -m vdetlib_tpu gen_vid_proto`` (the reference's
``gen_vid_proto_file`` tool): frames are natural-sorted and numbered
1-based; paths are stored relative to the root (host code; no device).
"""

from __future__ import annotations

import argparse
import os

from vdetlib_tpu_torch.protos import proto_dump
from vdetlib_tpu_torch.utils.common import natural_sort

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def gen_vid_proto(frame_dir: str, video: str | None = None, root_path: str | None = None) -> dict:
    frame_dir = os.path.abspath(frame_dir)
    if video is None:
        video = os.path.basename(frame_dir.rstrip("/"))
    if root_path is None:
        root_path = os.path.dirname(frame_dir)
    files = [f for f in os.listdir(frame_dir) if os.path.splitext(f)[1].lower() in IMAGE_EXTS]
    frames = []
    for i, f in enumerate(natural_sort(files), start=1):
        rel = os.path.relpath(os.path.join(frame_dir, f), root_path)
        frames.append({"frame": i, "path": rel})
    return {"video": video, "root_path": root_path, "frames": frames}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frame_dir", help="directory containing frame images")
    p.add_argument("output", help="output vid_proto path (.json or .json.gz)")
    p.add_argument("--video", default=None, help="video name (default: dir name)")
    p.add_argument("--root_path", default=None, help="root for relative frame paths")
    args = p.parse_args(argv)
    proto = gen_vid_proto(args.frame_dir, args.video, args.root_path)
    proto_dump(proto, args.output)
    print(f"wrote {args.output}: {len(proto['frames'])} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
