"""Port parity: the fused pipeline (the slice as a whole) against the JAX one.

Same frames, proposals and converted weights through
``vdetlib_tpu.pipeline.fused`` and ``vdetlib_tpu_torch.pipeline.fused`` at
the tiny preset (96×128, T=8, R=16, C=4, two greedy track rounds).

- End to end: the cross-compilation bound of ``__graft_entry__.py`` (one
  bf16 program compiled two ways): bool fields and ``n_tracks`` exact,
  ``path_ids`` differing on < 1% of slots, boxes within 0.5 px, scores
  within 0.01. The detector runs in float32 here (backbone and head, in
  both packages): at bf16 the two frameworks round at different places
  (XLA keeps excess precision inside fusions), which moves detection scores
  by up to ~4e-3 and flips score thresholds — a different result, not a
  port fault. tests/test_torch_detector.py holds the bf16 detector.
- Teacher-forced: the JAX detection outputs are fed to the torch
  ``temporal`` stages (and, through a stand-in detection step, to the JAX
  pipeline). Every discrete field must then be exact; floats keep the
  bounds above (the flow differs at bf16 level, see tests/test_torch_flow.py).
- ``fused_to_protos``: the same det_proto and tubelets as the JAX function.
- ``pad_snippet``: a bucket-padded run equals the unpadded one on real frames.

Per the parity-test blind spots (CLAUDE.md), the fixture asserts that slot
layouts and roi counts vary from frame to frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fused_common import HW, C, R, f32_nets
from vdetlib_tpu.data.synth import SynthConfig, make_video
from vdetlib_tpu.pipeline import fused as jfused
from vdetlib_tpu.video.detect import _detect_step as j_detect_step
from vdetlib_tpu_torch.pipeline import fused as tfused

torch.set_num_threads(2)

T, A = 8, 4
NB = 24
TOL = {"det_boxes": 0.5, "track_boxes": 0.5, "det_scores": 0.01, "track_conf": 0.01,
       "tubelet_stats": 0.01, "final_scores": 0.01}


def _cfg(mod):
    return mod.FusedConfig(
        image_hw=HW, detect_batch=4, feat_batch=4, anchors_per_round=A, max_tracks=2 * A,
        max_paths=16, det_budget=NB, out_budget=NB, score_thresh=0.2, anchor_thresh=0.26,
    )


def _inputs(seed):
    sv = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=C,
                                seed=seed))
    rng = np.random.default_rng(seed)
    rois = np.zeros((T, R, 4), np.float32)
    roi_mask = np.zeros((T, R), bool)
    for t in range(T):
        # proposals around the objects plus clutter, a varying count per frame
        k = rng.integers(0, sv.gt_boxes.shape[0], R)
        jit = rng.normal(0, 4, (R, 4)).astype(np.float32)
        rois[t] = np.clip(sv.gt_boxes[k, t] + jit, 0, [HW[1] - 1, HW[0] - 1] * 2)
        roi_mask[t, : R - rng.integers(0, 6)] = True
    return sv.frames, rois, roi_mask


@pytest.fixture(scope="module")
def nets():
    n = f32_nets()
    jpipe = jfused.make_fused_pipeline(n.jdet, n.jtrk, n.jtrk_cfg, _cfg(jfused))
    tpipe = tfused.make_fused_pipeline(n.tdet, n.ttrk, n.ttrk_cfg, _cfg(tfused))
    return n.jdet, n.jdp, n.jtrk, n.jtp, n.jtrk_cfg, jpipe, tpipe


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(out):
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _compare(got, want, exact_paths=False):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.dtype == bool or name == "n_tracks":
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "path_ids":
            if exact_paths:
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                assert (g != w).mean() < 0.01, (g != w).mean()
        else:
            m = np.ones(w.shape, bool)
            if name == "det_boxes":
                m = want["det_mask"]
            elif name == "track_boxes":
                m = want["track_alive"]
            np.testing.assert_allclose(g[m], w[m], atol=TOL[name], rtol=0, err_msg=name)


def _preconditions(frames, rois, roi_mask, out):
    """The fixture varies what a parity test can silently hold constant."""
    assert len(set(roi_mask.sum(1).tolist())) > 1, "roi counts do not vary"
    mask, scores = out["det_mask"], out["det_scores"]
    layouts = {tuple(np.argmax(scores[t], -1)[mask[t]].tolist()) for t in range(T)}
    assert len(layouts) > 1 and len(set(mask.sum(1).tolist())) > 1, "slot layout is constant"
    assert int(out["n_tracks"]) > A, "the second greedy round never ran"
    assert (out["path_ids"] >= 0).any() and (out["final_scores"] < 0).any()


@pytest.fixture(scope="module")
def runs(nets):
    jdet, jdp, jtrk, jtp, jtrk_cfg, jpipe, tpipe = nets
    frames, rois, roi_mask = _inputs(11)
    want = _np(jpipe(jdp, jtp, jnp.asarray(frames), jnp.asarray(rois), None,
                     jnp.asarray(roi_mask)))
    with torch.no_grad():
        got = _np(tpipe(_t(frames), _t(rois), None, _t(roi_mask)))
    return frames, rois, roi_mask, want, got


def test_fused_end_to_end_matches_jax(runs):
    frames, rois, roi_mask, want, got = runs
    _preconditions(frames, rois, roi_mask, want)
    _compare(got, want)


def test_fused_teacher_forced_matches_jax_exactly(nets, runs, monkeypatch):
    jdet, jdp, jtrk, jtp, jtrk_cfg, _, tpipe = nets
    frames, rois, roi_mask, _, _ = runs
    B = 4
    probs, boxes = [], []
    for i in range(0, T, B):
        p, b = j_detect_step(jdet, jdp, jnp.asarray(frames[i:i + B]), jnp.asarray(rois[i:i + B]),
                             True)
        probs.append(np.asarray(p))
        boxes.append(np.asarray(b))
    probs, boxes = np.concatenate(probs), np.concatenate(boxes)
    table_rois = jnp.asarray(rois)

    def teacher(model, params, images_u8, rois_b, regress, net_hw=None):
        # each frame's proposals are unique: find its row, return JAX's outputs
        d = jnp.abs(rois_b[:, None] - table_rois[None]).sum((2, 3))  # (B, T)
        t = jnp.argmin(d, axis=1)
        return jnp.asarray(probs)[t], jnp.asarray(boxes)[t]

    monkeypatch.setattr(jfused, "_detect_step", teacher)
    jpipe = jfused.make_fused_pipeline(jdet, jtrk, jtrk_cfg, _cfg(jfused))
    want = _np(jpipe(jdp, jtp, jnp.asarray(frames), jnp.asarray(rois), None,
                     jnp.asarray(roi_mask)))
    with torch.no_grad():
        got = _np(tpipe.temporal(_t(frames), _t(probs), _t(boxes), None, _t(roi_mask)))
    _preconditions(frames, rois, roi_mask, want)
    _compare(got, want, exact_paths=True)


def test_fused_to_protos_matches_jax(runs):
    frames, rois, roi_mask, want, got = runs
    fids = list(range(1, T + 1))
    jo = jfused.FusedOutput(**{k: jnp.asarray(v) for k, v in want.items()})
    to = tfused.FusedOutput(**{k: torch.from_numpy(v) for k, v in got.items()})
    jdet_p, jtrk_p = jfused.fused_to_protos(jo, fids, "v")
    tdet_p, ttrk_p = tfused.fused_to_protos(to, fids, "v")
    jd, td = jdet_p["detections"], tdet_p["detections"]
    assert len(jd) > 0 and len(td) == len(jd)
    for a, b in zip(td, jd):
        assert a["frame"] == b["frame"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=0.5, rtol=0)
        assert [s["class"] for s in a["scores"]] == [s["class"] for s in b["scores"]]
        np.testing.assert_allclose([s["score"] for s in a["scores"]],
                                   [s["score"] for s in b["scores"]], atol=0.01, rtol=0)
    assert [len(t) for t in ttrk_p["tracks"]] == [len(t) for t in jtrk_p["tracks"]]


def test_fused_padded_bucket_matches_unpadded(nets, runs):
    *_, tpipe = nets
    frames, rois, roi_mask, _, base = runs
    fp, rp, t_valid = tfused.pad_snippet(frames, rois, bucket=2 * T)
    assert fp.shape[0] == 2 * T and t_valid == T
    mp = np.concatenate([roi_mask, np.zeros_like(roi_mask)])
    with torch.no_grad():
        padded = _np(tpipe(_t(fp), _t(rp), t_valid, _t(mp)))
    np.testing.assert_array_equal(padded["det_mask"][:T], base["det_mask"])
    np.testing.assert_allclose(padded["det_scores"][:T], base["det_scores"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(padded["final_scores"][:, :T], base["final_scores"], atol=1e-4,
                               rtol=0)
    assert int(padded["n_tracks"]) == int(base["n_tracks"])
    assert not padded["det_mask"][T:].any()
    assert (padded["final_scores"][:, T:] <= 0).all()


OPTIONS = dict(snap_weight=0.5, snap_iou=0.4, tubelet_boxes=True, flow_preset="accurate",
               flow_levels=2)
EMA = dict(template_eta=0.1, template_update_conf=0.3)


def test_fused_options_match_jax(nets, runs):
    """Every option of the fused pipeline at once — detection snapping, EMA
    templates, tubelet boxes and the "accurate" flow pyramid — against JAX's
    pipeline, end to end, at the bounds above. Each option changes the
    port's output on this fixture (checked one at a time)."""
    import dataclasses

    jdet, jdp, jtrk, jtp, jtrk_cfg, _, _ = nets
    frames, rois, roi_mask, _, _ = runs
    # a gap: no proposal on one object at frames 2-5 (MGP's one-frame hops
    # fill its ends), which the tracks bridge: the case tubelet boxes are for
    gt = make_video(SynthConfig(num_frames=T, height=HW[0], width=HW[1], num_classes=C,
                                seed=11)).gt_boxes[0]
    roi_mask = roi_mask.copy()
    for t in (2, 3, 4, 5):
        ix = np.clip(np.minimum(rois[t, :, 2:], gt[t, 2:]) - np.maximum(rois[t, :, :2], gt[t, :2]),
                     0, None).prod(1)
        roi_mask[t] &= ix < 0.2 * np.prod(gt[t, 2:] - gt[t, :2])
    n = f32_nets()
    jcfg = dataclasses.replace(_cfg(jfused), **OPTIONS)
    jpipe = jfused.make_fused_pipeline(jdet, jtrk, dataclasses.replace(jtrk_cfg, **EMA), jcfg)
    want = _np(jpipe(jdp, jtp, jnp.asarray(frames), jnp.asarray(rois), None,
                     jnp.asarray(roi_mask)))
    tcfg = dataclasses.replace(_cfg(tfused), **OPTIONS)
    ttrk_cfg = dataclasses.replace(n.ttrk_cfg, **EMA)

    def port(cfg, trk_cfg):
        with torch.no_grad():
            return _np(tfused.make_fused_pipeline(n.tdet, n.ttrk, trk_cfg, cfg)(
                _t(frames), _t(rois), None, _t(roi_mask)))

    got = port(tcfg, ttrk_cfg)
    _preconditions(frames, rois, roi_mask, want)
    _compare(got, want)
    for off, trk_cfg in ((dict(snap_weight=0.0), ttrk_cfg), ({}, n.ttrk_cfg),
                         (dict(tubelet_boxes=False), ttrk_cfg),
                         (dict(flow_preset="fastest"), ttrk_cfg)):
        other = port(dataclasses.replace(tcfg, **off), trk_cfg)
        assert any(not np.array_equal(other[k], got[k]) for k in got), off
        if "tubelet_boxes" in off:  # track boxes fill slots the dets leave empty
            assert got["det_mask"].sum() > other["det_mask"].sum()
