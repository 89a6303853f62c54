"""Import an ImageNet VID (ILSVRC devkit layout) split into pipeline protos.

Counterpart of ``python -m vdetlib_tpu import_vid`` (host code; no device)."""

from __future__ import annotations

import argparse

from vdetlib_tpu_torch.data.vid_dataset import import_vid_split


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_root", help="ILSVRC root (contains Data/VID, Annotations/VID)")
    p.add_argument("out_dir")
    p.add_argument("--split", default="val")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    names = import_vid_split(args.data_root, args.out_dir, args.split, args.limit)
    print(f"imported {len(names)} snippets to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
