"""ImageNet VID import, ILSVRC devkit layout → protos — the port's copy of
``vdetlib_tpu/data/vid_dataset.py``.

The reference consumed ImageNet VID snippets (JPEG frame directories) and
devkit annotations (one PASCAL-style XML per frame with
``<object><trackid>`` entries). This module turns that layout into
vid_proto + annot_proto, so the pipeline runs on real VID data unchanged:

    Data/VID/val/ILSVRC2015_val_00000000/{000000.JPEG, ...}
    Annotations/VID/val/ILSVRC2015_val_00000000/{000000.xml, ...}

The 30 VID class WNIDs map to class indices 1..30 (0 = background).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

from vdetlib_tpu_torch.cli.gen_vid_proto import gen_vid_proto
from vdetlib_tpu_torch.protos import proto_dump
from vdetlib_tpu_torch.utils.common import natural_sort

# ILSVRC2015 VID: 30 categories, canonical devkit order.
VID_WNIDS = (
    "n02691156", "n02419796", "n02131653", "n02834778", "n01503061",
    "n02924116", "n02958343", "n02402425", "n02084071", "n02121808",
    "n02503517", "n02118333", "n02510455", "n02342885", "n02374451",
    "n02129165", "n01674464", "n02484322", "n03790512", "n02324045",
    "n02509815", "n02411705", "n01726692", "n02355227", "n02129604",
    "n04468005", "n01662784", "n04530566", "n02062744", "n02391049",
)
VID_CLASS_NAMES = (
    "airplane", "antelope", "bear", "bicycle", "bird", "bus", "car",
    "cattle", "dog", "domestic_cat", "elephant", "fox", "giant_panda",
    "hamster", "horse", "lion", "lizard", "monkey", "motorcycle",
    "rabbit", "red_panda", "sheep", "snake", "squirrel", "tiger",
    "train", "turtle", "watercraft", "whale", "zebra",
)
WNID_TO_INDEX = {w: i + 1 for i, w in enumerate(VID_WNIDS)}  # 1-based
INDEX_TO_NAME = {i + 1: n for i, n in enumerate(VID_CLASS_NAMES)}


def parse_vid_xml(path: str) -> list[dict]:
    """One devkit frame XML → [{trackid, wnid, bbox, occluded, generated}]."""
    root = ET.parse(path).getroot()
    out = []
    for obj in root.findall("object"):
        wnid = obj.findtext("name", "").strip()
        box = obj.find("bndbox")
        if box is None:
            continue
        bbox = [float(box.findtext(k, "0")) for k in ("xmin", "ymin", "xmax", "ymax")]
        out.append({
            "trackid": int(obj.findtext("trackid", "0")),
            "wnid": wnid,
            "bbox": bbox,
            "occluded": obj.findtext("occluded", "0") == "1",
            "generated": obj.findtext("generated", "0") == "1",
        })
    return out


def import_vid_snippet(frames_dir: str, annotations_dir: Optional[str] = None,
                       video: Optional[str] = None) -> tuple[dict, Optional[dict]]:
    """One snippet directory → (vid_proto, annot_proto or None)."""
    vid_proto = gen_vid_proto(frames_dir, video=video)
    video = vid_proto["video"]
    if annotations_dir is None or not os.path.isdir(annotations_dir):
        return vid_proto, None

    xmls = natural_sort([f for f in os.listdir(annotations_dir) if f.endswith(".xml")])
    tracks: dict[int, list] = {}
    track_wnid: dict[int, str] = {}
    for frame_id, xml_name in enumerate(xmls, start=1):
        for obj in parse_vid_xml(os.path.join(annotations_dir, xml_name)):
            ci = WNID_TO_INDEX.get(obj["wnid"])
            if ci is None:
                continue
            tid = obj["trackid"]
            track_wnid.setdefault(tid, obj["wnid"])
            tracks.setdefault(tid, []).append({
                "frame": frame_id,
                "bbox": obj["bbox"],
                "class": INDEX_TO_NAME[ci],
                "class_index": ci,
                "occluded": obj["occluded"],
                "generated": obj["generated"],
            })
    annot = {
        "video": video,
        "annotations": [{"id": tid, "wnid": track_wnid[tid], "track": boxes}
                        for tid, boxes in sorted(tracks.items())],
    }
    return vid_proto, annot


def import_vid_split(data_root: str, out_dir: str, split: str = "val",
                     limit: Optional[int] = None) -> list[str]:
    """Walk Data/VID/<split>; write NAME.vid.json (+ NAME.annot.json) in the
    layout the ``pipeline`` tool reads; returns the snippet names."""
    frames_root = os.path.join(data_root, "Data", "VID", split)
    annot_root = os.path.join(data_root, "Annotations", "VID", split)
    if not os.path.isdir(frames_root):
        raise FileNotFoundError(f"no Data/VID/{split} under {data_root}")
    os.makedirs(out_dir, exist_ok=True)
    names = []
    for name in natural_sort(os.listdir(frames_root)):
        snippet_dir = os.path.join(frames_root, name)
        if not os.path.isdir(snippet_dir):
            continue
        vid, annot = import_vid_snippet(snippet_dir, os.path.join(annot_root, name), video=name)
        proto_dump(vid, os.path.join(out_dir, f"{name}.vid.json"))
        if annot is not None:
            proto_dump(annot, os.path.join(out_dir, f"{name}.annot.json"))
        names.append(name)
        if limit and len(names) >= limit:
            break
    return names
