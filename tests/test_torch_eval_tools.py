"""Port parity: evaluation, calibration and submission — ``evaluation/submission.py``,
``evaluation/calibration.py`` (Platt half) and the tools ``write_submission``,
``calibrate`` and ``eval_vid`` — against the JAX package on the same protos.

The protos are synthetic detector outputs over three videos
(``data/synth.py::det_proto_from_gt`` with dropout windows and distractors,
their ``annot_proto``; the port's synthetic data equals JAX's, see
tests/test_torch_protos_synth.py). Both packages are numpy on the host, so
the bounds are tight: files and lines byte for byte, TP samples equal, the
Brier score and the Platt parameters within 1e-9 (float64), calibrated
protos and the tools' files equal.
"""

import json

import numpy as np
import pytest

from vdetlib_tpu.cli import calibrate as j_calibrate
from vdetlib_tpu.cli import eval_vid as j_eval_vid
from vdetlib_tpu.cli import write_submission as j_write_submission
from vdetlib_tpu.evaluation import calibration as jcal
from vdetlib_tpu.evaluation import submission as jsub
from vdetlib_tpu_torch.cli import calibrate, eval_vid, write_submission
from vdetlib_tpu_torch.data.synth import (SynthConfig, annot_proto, det_proto_from_gt,
                                          make_video, vid_proto_in_memory)
from vdetlib_tpu_torch.evaluation import calibration as tcal
from vdetlib_tpu_torch.evaluation import submission as tsub
from vdetlib_tpu_torch.evaluation.vid_map import vid_map
from vdetlib_tpu_torch.protos import proto_dump

LENGTHS = (12, 9, 15)
NUM_CLASSES = 6


@pytest.fixture(scope="module")
def videos():
    """(vid_proto, det_proto, annot_proto) for each video."""
    out = []
    for i, T in enumerate(LENGTHS):
        sv = make_video(SynthConfig(num_frames=T, height=96, width=128,
                                    num_classes=NUM_CLASSES, num_objects=3, seed=60 + i),
                        video=f"ev{i}")
        det = det_proto_from_gt(sv, dropout_windows=1, distractors_per_frame=4)
        out.append((vid_proto_in_memory(sv), det, annot_proto(sv)))
    return out


@pytest.fixture(scope="module")
def files(videos, tmp_path_factory):
    """The protos on disk: {video: (vid, det, annot) paths}."""
    root = tmp_path_factory.mktemp("protos")
    paths = []
    for vid, det, annot in videos:
        p = tuple(str(root / f"{vid['video']}.{k}.json") for k in ("vid", "det", "annot"))
        for proto, path in zip((vid, det, annot), p):
            proto_dump(proto, path)
        paths.append(p)
    return paths


def _pairs(videos):
    return [(det, annot) for _, det, annot in videos]


@pytest.mark.parametrize("offset, min_score", [(0, 0.0), (17, 0.0), (5, 0.5)])
def test_submission_lines_match_jax(videos, offset, min_score):
    for _, det, _ in videos:
        got = tsub.submission_lines(det, frame_offset=offset, min_score=min_score)
        assert got == jsub.submission_lines(det, frame_offset=offset, min_score=min_score)
        assert got


@pytest.mark.parametrize("min_score", [0.0, 0.5])
def test_write_submission_matches_jax(videos, tmp_path, min_score):
    dets, vids = [v[1] for v in videos], [v[0] for v in videos]
    n = tsub.write_submission(dets, vids, str(tmp_path / "t.txt"), min_score=min_score)
    jn = jsub.write_submission(dets, vids, str(tmp_path / "j.txt"), min_score=min_score)
    assert n == jn > 0
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    frames = [int(line.split()[0]) for line in (tmp_path / "t.txt").read_text().splitlines()]
    assert max(frames) > LENGTHS[0]  # numbered globally across the videos


def test_collect_tp_samples_and_brier_match_jax(videos):
    pairs = _pairs(videos)
    for thresh in (0.5, 0.7):
        got = tcal.collect_tp_samples(pairs, thresh)
        want = jcal.collect_tp_samples(pairs, thresh)
        assert dict(got) == dict(want)
        labels = [y for v in got.values() for _, y in v]
        assert 0 < sum(labels) < len(labels)  # both TPs and FPs
        assert abs(tcal.brier_score(pairs, thresh) - jcal.brier_score(pairs, thresh)) <= 1e-9


def test_platt_matches_jax_and_round_trips(videos):
    pairs = _pairs(videos)
    cal = tcal.PlattCalibrator().fit(pairs)
    jc = jcal.PlattCalibrator().fit(pairs)
    assert sorted(cal.params) == sorted(jc.params)
    for ci in jc.params:
        np.testing.assert_allclose(cal.params[ci], jc.params[ci], rtol=0, atol=1e-9)
    np.testing.assert_allclose(cal.global_params, jc.global_params, rtol=0, atol=1e-9)
    # some class has its own fit and some falls back to the global one
    assert any(len(v) >= cal.min_samples for v in tcal.collect_tp_samples(pairs).values())
    for args in ([], [(0.2, 1.0), (0.9, 0.0)], [(s / 10, float(s % 2)) for s in range(10)]):
        assert tcal._fit_platt(args) == pytest.approx(jcal._fit_platt(args), abs=1e-9)
    # to_json / from_json
    back = tcal.PlattCalibrator.from_json(json.loads(json.dumps(cal.to_json())))
    assert back.params == cal.params and back.global_params == cal.global_params
    assert back.iou_thresh == cal.iou_thresh
    assert cal.to_json().keys() == jc.to_json().keys()
    for _, det, _ in videos:
        assert back.transform(det) == cal.transform(det)


@pytest.mark.parametrize("method, blend", [("rank", 0.0), ("rank", 0.3), ("platt", 0.0)])
def test_calibrate_det_protos_matches_jax(videos, method, blend):
    dets = [v[1] for v in videos]
    pairs = _pairs(videos) if method == "platt" else None
    got = tcal.calibrate_det_protos(dets, method, val_pairs=pairs, blend=blend)
    want = jcal.calibrate_det_protos(dets, method, val_pairs=pairs, blend=blend)
    assert len(got) == len(want) == len(dets)
    for g, w in zip(got, want):
        assert g["video"] == w["video"] and len(g["detections"]) == len(w["detections"])
        a = [s["score"] for d in g["detections"] for s in d["scores"]]
        b = [s["score"] for d in w["detections"] for s in d["scores"]]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="val_pairs"):
        tcal.calibrate_det_protos(dets, "platt")
    with pytest.raises(ValueError, match="unknown"):
        tcal.calibrate_det_protos(dets, "isotonic")


def _tool_run(tmp_path, files, tool, argv_of):
    """Run ``tool`` on copies of the det protos under ``tmp_path``; returns
    {output name: bytes}."""
    out = {}
    dets = []
    for vid_p, det_p, _ in files:
        p = tmp_path / f"{vid_p.split('/')[-1][:-9]}.final.json"
        p.write_bytes(open(det_p, "rb").read())
        dets.append(str(p))
    assert tool(argv_of(dets)) == 0
    for p in sorted(tmp_path.iterdir()):
        out[p.name] = p.read_bytes()
    return out


@pytest.mark.parametrize("argv", [[], ["--blend", "0.25"], ["--method", "platt"]],
                         ids=["rank", "rank_blend", "platt"])
def test_calibrate_tool_matches_jax(files, tmp_path, argv):
    def argv_of(root):
        def f(dets):
            extra = []
            if "platt" in argv:
                extra = ["--val_dets", *[p[1] for p in files], "--val_annots",
                         *[p[2] for p in files], "--save_model", str(root / "cal.json")]
            return [*dets, *argv, *extra]
        return f

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _tool_run(tmp_path / "t", files, calibrate.main, argv_of(tmp_path / "t"))
    want = _tool_run(tmp_path / "j", files, j_calibrate.main, argv_of(tmp_path / "j"))
    assert got.keys() == want.keys()
    assert len([k for k in got if k.endswith(".cal.json")]) == len(files)
    for k in got:
        if k == "cal.json":  # the fitted parameters: float64 within 1e-9
            a, b = json.loads(got[k]), json.loads(want[k])
            assert a.keys() == b.keys() and a["per_class"].keys() == b["per_class"].keys()
            np.testing.assert_allclose(a["global"], b["global"], rtol=0, atol=1e-9)
            for ci in a["per_class"]:
                np.testing.assert_allclose(a["per_class"][ci], b["per_class"][ci], rtol=0,
                                           atol=1e-9)
        else:
            assert got[k] == want[k], k


def test_calibrate_tool_load_model(files, tmp_path):
    """``--load_model`` applies a saved fit: the same files as the fit's run."""
    fit = tmp_path / "fit"
    fit.mkdir()
    val = ["--val_dets", *[p[1] for p in files], "--val_annots", *[p[2] for p in files]]
    first = _tool_run(fit, files, calibrate.main, lambda d: [
        *d, "--method", "platt", *val, "--save_model", str(tmp_path / "cal.json")])
    (tmp_path / "load").mkdir()
    again = _tool_run(tmp_path / "load", files, calibrate.main, lambda d: [
        *d, "--method", "platt", "--load_model", str(tmp_path / "cal.json")])
    assert again == first
    with pytest.raises(SystemExit):
        calibrate.main([files[0][1], "--method", "platt"])


@pytest.mark.parametrize("argv", [[], ["--min_score", "0.5"], ["--calibration"]],
                         ids=["raw", "min_score", "calibrated"])
def test_write_submission_tool_matches_jax(files, tmp_path, argv):
    if argv == ["--calibration"]:
        pairs = [(json.load(open(d)), json.load(open(a))) for _, d, a in files]
        (tmp_path / "cal.json").write_text(json.dumps(tcal.PlattCalibrator().fit(pairs)
                                                      .to_json()))
        argv = ["--calibration", str(tmp_path / "cal.json"), "--min_score", "0.3"]
    pairs = [p for vid, det, _ in files for p in (vid, det)]
    assert write_submission.main([str(tmp_path / "t.txt"), "--pairs", *pairs, *argv]) == 0
    assert j_write_submission.main([str(tmp_path / "j.txt"), "--pairs", *pairs, *argv]) == 0
    got = (tmp_path / "t.txt").read_bytes()
    assert got == (tmp_path / "j.txt").read_bytes() and got
    with pytest.raises(SystemExit):
        write_submission.main([str(tmp_path / "x.txt"), "--pairs", pairs[0]])


@pytest.mark.parametrize("iou", ["0.5", "0.7"])
def test_eval_vid_matches_jax(files, videos, tmp_path, iou, capsys):
    pairs = [p for _, det, annot in files for p in (det, annot)]
    assert eval_vid.main(["--pairs", *pairs, "--iou_thresh", iou,
                          "--json_out", str(tmp_path / "t.json")]) == 0
    printed = capsys.readouterr().out
    assert j_eval_vid.main(["--pairs", *pairs, "--iou_thresh", iou,
                            "--json_out", str(tmp_path / "j.json")]) == 0
    assert capsys.readouterr().out == printed
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    m, _ = vid_map(_pairs(videos), iou_thresh=float(iou))
    assert got["mAP"] == m and 0 < m <= 1
    assert f"mAP = {m:.4f}" in printed
