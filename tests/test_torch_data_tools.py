"""Port parity: the data and host tools — ``utils/common.py`` (natural sort,
temporal windows, ``imread``/``imwrite``), ``gen_vid_proto``,
``video/proposal.py`` with ``gen_box_proto``, ``data/vid_dataset.py`` with
``import_vid``, ``gen_synth``, ``utils/visual.py`` with ``show_det`` /
``show_track`` — against the JAX package, and the port's own rehearsal of
the real-data path through its tools.

Everything here is host code, so the bounds are exact: protos equal (the
tools' files byte for byte where both write the same root path), frames and
drawn images equal as decoded arrays. The devkit tree and the Selective
Search ``.mat`` files are made as JAX's rehearsal makes them
(tests/test_vid_rehearsal.py). The rehearsal runs ``import_vid`` →
``gen_box_proto`` → ``pipeline --device cpu --eval`` → ``write_submission``
→ ``eval_vid`` through the port's tools, with JAX's structural asserts.
"""

import json
import os
import re

import numpy as np
import pytest
import scipy.io

from tests.test_vid_rehearsal import NUM_SNIPPETS, T, _make_devkit_from_synth, _write_ss_mat
from vdetlib_tpu.cli import gen_box_proto as j_gen_box_proto
from vdetlib_tpu.cli import gen_synth as j_gen_synth
from vdetlib_tpu.cli import gen_vid_proto as j_gen_vid_proto
from vdetlib_tpu.cli import import_vid as j_import_vid
from vdetlib_tpu.cli import show as j_show
from vdetlib_tpu.data import vid_dataset as jvd
from vdetlib_tpu.utils import common as jcommon
from vdetlib_tpu.utils import visual as jvisual
from vdetlib_tpu.video import proposal as jprop
from vdetlib_tpu_torch.__main__ import dispatch
from vdetlib_tpu_torch.cli import (eval_vid, gen_box_proto, gen_synth, gen_vid_proto,
                                   import_vid, pipeline_tool, write_submission)
from vdetlib_tpu_torch.data import vid_dataset as tvd
from vdetlib_tpu_torch.data.synth import (SynthConfig, det_proto_from_gt, make_video,
                                          write_frames)
from vdetlib_tpu_torch.protos import proto_dump, proto_load
from vdetlib_tpu_torch.protos.accessors import dets_at_frame
from vdetlib_tpu_torch.utils import common as tcommon
from vdetlib_tpu_torch.utils import visual as tvisual
from vdetlib_tpu_torch.video import proposal as tprop


def _read_tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------- utils/common


def test_common_helpers_match_jax(tmp_path):
    names = ["frame_10.jpg", "frame_2.jpg", "frame_1.png", "a10b2", "a2b10", "a2b9", "x"]
    assert tcommon.natural_sort(names) == jcommon.natural_sort(names)
    for ids, w in (([1, 2, 3, 5, 6, 9], 1), ([4, 5, 6, 7], 2), ([3], 0)):
        assert tcommon.temporal_windows(ids, w) == jcommon.temporal_windows(ids, w)
    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    tcommon.imwrite(str(tmp_path / "sub" / "a.png"), img)
    assert np.array_equal(tcommon.imread(str(tmp_path / "sub" / "a.png")), img)
    assert np.array_equal(jcommon.imread(str(tmp_path / "sub" / "a.png")), img)
    with pytest.raises(FileNotFoundError):
        tcommon.imread(str(tmp_path / "missing.png"))


def test_missing_cv2_is_named(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)  # "import cv2" raises ImportError
    for call in (lambda: tcommon.imread(str(tmp_path / "a.png")),
                 lambda: tvisual.draw_box(np.zeros((8, 8, 3), np.uint8), [1, 1, 4, 4])):
        with pytest.raises(RuntimeError, match="cv2"):
            call()


# ---------------------------------------------------------------- gen_vid_proto


def test_gen_vid_proto_matches_jax(tmp_path):
    frames = tmp_path / "clip"
    frames.mkdir()
    for f in ("frame_10.jpg", "frame_2.JPEG", "frame_1.png", "frame_3.bmp", "notes.txt",
              "frame_11.jpeg"):
        (frames / f).write_bytes(b"x")
    for kw in ({}, {"video": "named"}, {"root_path": str(tmp_path.parent)}):
        got = gen_vid_proto.gen_vid_proto(str(frames), **kw)
        assert got == j_gen_vid_proto.gen_vid_proto(str(frames), **kw)
    assert [f["path"] for f in got["frames"]][:3] == [
        os.path.join(tmp_path.name, "clip", f) for f in ("frame_1.png", "frame_2.JPEG",
                                                         "frame_3.bmp")]
    assert gen_vid_proto.main([str(frames), str(tmp_path / "t.json")]) == 0
    assert j_gen_vid_proto.main([str(frames), str(tmp_path / "j.json")]) == 0
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


# ---------------------------------------------------------------- proposals


@pytest.fixture(scope="module")
def proposal_files(tmp_path_factory):
    """One proposal set in each input kind: {kind: path}."""
    root = tmp_path_factory.mktemp("proposals")
    rng = np.random.default_rng(3)
    Tn, N = 5, 7
    per_frame = []
    for t in range(Tn):
        xy = rng.uniform(1, 60, (N, 2))
        wh = rng.uniform(4, 40, (N, 2))
        per_frame.append(np.concatenate([xy, xy + wh], 1))
    per_frame[2] = np.concatenate([per_frame[2], per_frame[1][:3]])  # shared boxes: dedup
    cells = np.empty((Tn, 1), dtype=object)
    for t, b in enumerate(per_frame):
        cells[t, 0] = b[:, [1, 0, 3, 2]] if t != 3 else np.zeros((0, 4))  # yxyx; one empty
    scipy.io.savemat(str(root / "cell.mat"), {"boxes": cells})
    flat = np.concatenate([np.concatenate([np.full((len(b), 1), t + 1), b], 1)
                           for t, b in enumerate(per_frame)])
    scipy.io.savemat(str(root / "flat.mat"), {"all_boxes": flat})
    np.savez(str(root / "props.npz"), **{f"frame_{t + 1}": b for t, b in enumerate(per_frame)},
             other=np.zeros(3))
    proto_dump({"video": "v", "boxes": [{"frame": t + 1, "bbox": [float(x) for x in r]}
                                        for t, b in enumerate(per_frame) for r in b]},
               str(root / "props.json"))
    proto_dump({"video": "v", "detections": []}, str(root / "notbox.json"))
    return {k: str(root / f) for k, f in (("cell", "cell.mat"), ("flat", "flat.mat"),
                                          ("npz", "props.npz"), ("json", "props.json"),
                                          ("notbox", "notbox.json"))}


@pytest.mark.parametrize("kind, kw", [
    ("cell", {}), ("cell", {"top_k": 4}), ("cell", {"order": "xyxy", "one_based": False}),
    ("flat", {"order": "xyxy"}), ("npz", {}), ("npz", {"top_k": 3}), ("json", {})])
def test_load_proposals_matches_jax(proposal_files, kind, kw):
    got = tprop.load_proposals(proposal_files[kind], "v", **kw)
    assert got == jprop.load_proposals(proposal_files[kind], "v", **kw)
    assert len(got["boxes"]) > 0
    for w in (0, 1, 2):
        assert tprop.reuse_across_frames(got, w) == jprop.reuse_across_frames(got, w)
    ids = [1, 2, 3, 4, 5, 6]
    assert tprop.reuse_across_frames(got, 1, ids) == jprop.reuse_across_frames(got, 1, ids)


def test_load_proposals_refusals(proposal_files, tmp_path):
    with pytest.raises(ValueError, match="not a box_proto"):
        tprop.load_proposals(proposal_files["notbox"], "v")
    with pytest.raises(ValueError, match="unsupported"):
        tprop.load_proposals(str(tmp_path / "x.txt"), "v")
    with pytest.raises(ValueError, match="unknown box order"):
        tprop.load_proposals(proposal_files["cell"], "v", order="xxyy")
    scipy.io.savemat(str(tmp_path / "bad.mat"), {"boxes": np.zeros((3, 4))})
    with pytest.raises(ValueError, match=r"\(N, 5\)"):
        tprop.load_proposals(str(tmp_path / "bad.mat"), "v")


@pytest.mark.parametrize("kind, argv", [
    ("cell", []), ("cell", ["--top_k", "4", "--reuse_window", "1"]),
    ("flat", ["--order", "xyxy", "--zero_based"]), ("npz", ["--top_k", "2"]),
    ("json", ["--reuse_window", "2"])])
def test_gen_box_proto_tool_matches_jax(proposal_files, tmp_path, kind, argv):
    for name, main in (("t", gen_box_proto.main), ("j", j_gen_box_proto.main)):
        assert main([proposal_files[kind], str(tmp_path / f"{name}.json"), "--video", "v",
                     *argv]) == 0
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


# ---------------------------------------------------------------- import_vid


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = tmp_path_factory.mktemp("devkit")
    names, synth = _make_devkit_from_synth(str(root))
    return str(root), names, synth


def test_import_vid_matches_jax(devkit, tmp_path):
    root, names, _ = devkit
    assert tvd.VID_WNIDS == jvd.VID_WNIDS and tvd.VID_CLASS_NAMES == jvd.VID_CLASS_NAMES
    assert tvd.WNID_TO_INDEX == jvd.WNID_TO_INDEX and tvd.INDEX_TO_NAME == jvd.INDEX_TO_NAME
    adir = os.path.join(root, "Annotations", "VID", "val", names[0])
    xml = os.path.join(adir, sorted(os.listdir(adir))[0])
    assert tvd.parse_vid_xml(xml) == jvd.parse_vid_xml(xml)
    assert import_vid.main([root, str(tmp_path / "t")]) == 0
    assert j_import_vid.main([root, str(tmp_path / "j")]) == 0
    got = _read_tree(tmp_path / "t")
    assert got == _read_tree(tmp_path / "j")
    assert sorted(got) == sorted(f"{n}.{k}.json" for n in names for k in ("vid", "annot"))
    # --limit, and a snippet without annotations
    fdir = os.path.join(root, "Data", "VID", "val", names[1])
    vid, annot = tvd.import_vid_snippet(fdir, None)
    assert (vid, annot) == jvd.import_vid_snippet(fdir, None) and annot is None
    assert tvd.import_vid_split(root, str(tmp_path / "lim"), limit=1) == names[:1]
    with pytest.raises(FileNotFoundError):
        tvd.import_vid_split(root, str(tmp_path / "x"), split="test")


# ---------------------------------------------------------------- gen_synth


def _normalised(tree, root):
    """A gen_synth tree's protos with the output root taken out, and its frames."""
    protos, frames = {}, {}
    for k, v in tree.items():
        if k.endswith(".json"):
            protos[k] = json.loads(v.decode().replace(str(root), "ROOT"))
        else:
            frames[k] = v
    return protos, frames


@pytest.mark.parametrize("argv", [
    ["--num_videos", "2", "--frames", "5", "--height", "96", "--width", "128",
     "--proposals", "12", "--with_dets", "--dropout_windows", "1", "--class_coded"],
    ["--tier", "hard", "--num_videos", "1", "--frames", "6", "--height", "96", "--width", "128",
     "--num_classes", "6", "--proposals", "16", "--with_dets", "--scale_rate", "0.03",
     "--num_objects", "2", "--seed", "4"]], ids=["easy", "hard"])
def test_gen_synth_matches_jax(tmp_path, argv):
    import cv2

    assert gen_synth.main([str(tmp_path / "t"), *argv]) == 0
    assert j_gen_synth.main([str(tmp_path / "j"), *argv]) == 0
    tp, tf = _normalised(_read_tree(tmp_path / "t"), tmp_path / "t")
    jp, jf = _normalised(_read_tree(tmp_path / "j"), tmp_path / "j")
    assert tp == jp and any(k.endswith(".det.json") for k in tp)
    assert sorted(tf) == sorted(jf) and tf
    for k in tf:
        a = cv2.imread(str(tmp_path / "t" / k))
        assert a is not None and np.array_equal(a, cv2.imread(str(tmp_path / "j" / k))), k


# ---------------------------------------------------------------- visual


@pytest.fixture(scope="module")
def shown(tmp_path_factory):
    """A video on disk, its det_proto and a track_proto (dict and list tracks)."""
    root = tmp_path_factory.mktemp("show")
    sv = make_video(SynthConfig(num_frames=4, height=96, width=128, seed=9), video="clip")
    vid = write_frames(sv, str(root / "frames"))
    det = det_proto_from_gt(sv)
    tracks = {"video": "clip", "tracks": [
        [{"frame": f, "bbox": [10.0 + f, 12.0, 50.0, 60.0], "score": 0.8} for f in (1, 2, 3)],
        {"boxes": [{"frame": f, "bbox": [60.0, 20.0, 90.0 - f, 70.0]} for f in (2, 4)]}]}
    paths = {k: str(root / f"{k}.json") for k in ("vid", "det", "track")}
    for k, p in (("vid", vid), ("det", det), ("track", tracks)):
        proto_dump(p, paths[k])
    return root, vid, det, tracks, paths


def _decoded(paths):
    import cv2

    return [cv2.imread(p) for p in paths]


def test_visual_matches_jax(shown, tmp_path):
    _, vid, det, tracks, _ = shown
    for i in (0, 1, 7, 123):
        assert tvisual.unique_color(i) == jvisual.unique_color(i)
    assert dets_at_frame(det, 2) == [d for d in det["detections"] if d["frame"] == 2]
    for thresh in (0.0, 0.5):
        got = tvisual.show_detections(vid, det, str(tmp_path / f"t{thresh}"), thresh)
        want = jvisual.show_detections(vid, det, str(tmp_path / f"j{thresh}"), thresh)
        assert len(got) == len(want) == len(vid["frames"])
        for a, b in zip(_decoded(got), _decoded(want)):
            assert np.array_equal(a, b)
    got = tvisual.show_tracks(vid, tracks, str(tmp_path / "tt"))
    want = jvisual.show_tracks(vid, tracks, str(tmp_path / "jt"))
    for a, b in zip(_decoded(got), _decoded(want)):
        assert np.array_equal(a, b)
    frame = _decoded([os.path.join(vid["root_path"], vid["frames"][0]["path"])])[0]
    assert not np.array_equal(_decoded(got[:1])[0], frame)  # something was drawn


@pytest.mark.parametrize("tool, proto", [("show_det", "det"), ("show_track", "track"),
                                         ("show_det", "track")])
def test_show_tools_match_jax(shown, tmp_path, tool, proto):
    """Through the port's dispatcher (which passes ``tool=``) against JAX's tool."""
    _, vid, _, _, paths = shown
    argv = [paths["vid"], paths[proto]]
    assert dispatch(tool, argv + [str(tmp_path / "t"), "--score_thresh", "0.3"]) == 0
    assert j_show.main(argv + [str(tmp_path / "j"), "--score_thresh", "0.3"], tool=tool) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == len(vid["frames"])
    for n in names:
        a, b = _decoded([str(tmp_path / d / n) for d in ("t", "j")])
        assert np.array_equal(a, b), n


# ---------------------------------------------------------------- the rehearsal


def test_devkit_to_submission_rehearsal_in_the_port(devkit, tmp_path, capsys):
    """JAX's rehearsal (tests/test_vid_rehearsal.py) through the port's tools,
    the pipeline on the CPU."""
    root, names, synth = devkit
    protos, work = str(tmp_path / "protos"), str(tmp_path / "work")
    rng = np.random.default_rng(0)

    # 1. devkit → vid/annot protos
    assert import_vid.main([root, protos]) == 0
    for name in names:
        assert os.path.exists(os.path.join(protos, f"{name}.vid.json"))
        assert os.path.exists(os.path.join(protos, f"{name}.annot.json"))

    # 2. SS .mat → box protos
    for name, sv in zip(names, synth):
        mat = str(tmp_path / f"{name}.mat")
        _write_ss_mat(mat, sv, rng)
        assert gen_box_proto.main([mat, os.path.join(protos, f"{name}.box.json"),
                                   "--video", name]) == 0
    annot = proto_load(os.path.join(protos, f"{names[0]}.annot.json"))
    got = sorted({a["track"][0]["class_index"] for a in annot["annotations"]})
    assert got == sorted({int(c) for c in synth[0].gt_classes})
    for a in annot["annotations"]:
        assert a["track"][0]["class_index"] == tvd.WNID_TO_INDEX[a["wnid"]]

    # 3. the staged pipeline over the imported protos, with eval
    assert pipeline_tool.main([protos, work, "--model", "tiny", "--num_classes", "31",
                               "--image_hw", "96", "128", "--max_rois", "16", "--eval",
                               "--device", "cpu"]) == 0
    m = re.search(r"mAP = ([\d.]+) over 2 videos", capsys.readouterr().out)
    assert m and np.isfinite(float(m.group(1)))

    # 4. final det protos → ILSVRC submission file
    sub = str(tmp_path / "submission.txt")
    pairs = [p for name in names for p in (os.path.join(protos, f"{name}.vid.json"),
                                           os.path.join(work, name, "final.json"))]
    assert write_submission.main([sub, "--pairs", *pairs]) == 0
    lines = open(sub).read().splitlines()
    assert lines, "submission is empty"
    pat = re.compile(r"^\d+ \d+ \d+\.\d{6} -?\d+\.\d{2} -?\d+\.\d{2} -?\d+\.\d{2} -?\d+\.\d{2}$")
    for line in lines:
        assert pat.match(line), line
    frames = [int(line.split()[0]) for line in lines]
    assert min(frames) >= 1 and max(frames) <= NUM_SNIPPETS * T
    assert all(1 <= int(line.split()[1]) <= 30 for line in lines)

    # 5. standalone eval over (final det, imported annot) pairs
    ev = str(tmp_path / "eval.json")
    pairs = [p for name in names for p in (os.path.join(work, name, "final.json"),
                                           os.path.join(protos, f"{name}.annot.json"))]
    assert eval_vid.main(["--pairs", *pairs, "--json_out", ev]) == 0
    res = json.load(open(ev))
    assert np.isfinite(res["mAP"]) and 0.0 <= res["mAP"] <= 1.0
