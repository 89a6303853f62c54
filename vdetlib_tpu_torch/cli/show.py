"""Visualization tools ``show_det`` / ``show_track``: annotated frame dumps.

Counterpart of JAX's ``show_det`` / ``show_track`` (host code; no device;
needs ``cv2``), over ``utils/visual.py``. The dispatcher passes the tool's
name as ``tool``.
"""

from __future__ import annotations

import argparse

from vdetlib_tpu_torch.protos import proto_load
from vdetlib_tpu_torch.utils.visual import show_detections, show_tracks


def main(argv=None, tool: str = "show_det") -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("vid_file")
    p.add_argument("proto_file", help="det_proto (show_det) or track_proto (show_track)")
    p.add_argument("out_dir")
    p.add_argument("--score_thresh", type=float, default=0.1)
    args = p.parse_args(argv)

    vid = proto_load(args.vid_file)
    proto = proto_load(args.proto_file)
    if tool == "show_track" or "tracks" in proto:
        written = show_tracks(vid, proto, args.out_dir)
    else:
        written = show_detections(vid, proto, args.out_dir, args.score_thresh)
    print(f"wrote {len(written)} annotated frames to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
