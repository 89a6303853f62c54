"""Data parallelism over ``torch.distributed``: ``dist/`` (meshes, sharding,
``init_multihost``, ``process_video_shard``, ``allreduce_metrics``),
``pipeline/fused.py::make_sharded_pipeline``, the sharded detector train
step and ``pipeline --multihost``.

Two coordinated gloo processes on the CPU, launched from the test with
``sys.executable -c`` and retried with a fresh port when the probed port is
taken before the group binds it (JAX's ``tests/test_multihost.py``
pattern). Each process runs the same code on the same CPU, so sharded and
unsharded runs of the pipeline agree bit for bit; the sharded train step
sums gradients in another order than one process does and is held within
1e-4 of each tensor's largest element (the detector's bound of
``tests/test_torch_train.py``). One in-process test holds the port's
``make_sharded_pipeline`` on a one-rank group against JAX's on conftest's
CPU mesh within the North star bounds, and destroys its group after.
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_pair(make_args, timeout, attempts=3, before_attempt=None):
    """Run the two coordinated processes, retrying with a fresh port."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for attempt in range(attempts):
        if before_attempt is not None:
            before_attempt()
        port = _free_port()
        procs = [subprocess.Popen(make_args(port, i), cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for i in range(2)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return logs
        if attempt == attempts - 1:
            raise AssertionError(f"multihost pair failed {attempts}x: {logs}")
    raise AssertionError("unreachable")


# ---------------------------------------------------------------- dist/

WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from vdetlib_tpu_torch.dist import make_mesh, psum_metrics, replicate, shard_batch
from vdetlib_tpu_torch.dist.multihost import (allreduce_metrics, init_multihost,
                                             process_video_shard)

port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
assert init_multihost()  # a second call finds the group up
videos = [f"v{i}" for i in range(7)]
mine = process_video_shard(videos)
total = allreduce_metrics({"videos": len(mine), "frames": 10.0 * len(mine)})
mesh = make_mesh()
x = shard_batch(mesh, {"x": torch.arange(16.0).reshape(16, 1), "y": np.arange(16)})
w = replicate(mesh, torch.full((3,), float(pid + 1)))
psum = psum_metrics({"frames": torch.tensor(10.0 * len(mine)), "videos": 1.0}, mesh=mesh)
mesh2 = make_mesh(2, model_parallel=2)
x2 = shard_batch(mesh2, torch.arange(4))
with open(out, "w") as f:
    json.dump({"mine": mine, "total": total, "mesh": list(mesh.shape),
               "mesh2": list(mesh2.shape), "x": x["x"][:, 0].tolist(), "y": x["y"].tolist(),
               "w": w.tolist(), "psum": {k: float(v) for k, v in psum.items()},
               "x2": x2.tolist()}, f)
dist.destroy_process_group()
"""


def test_two_process_shard_and_allreduce(tmp_path):
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    _launch_pair(lambda port, i: [sys.executable, "-c", WORKER, str(port), str(i), outs[i]],
                 timeout=120)
    results = [json.load(open(o)) for o in outs]
    shards = [set(r["mine"]) for r in results]
    assert shards[0].isdisjoint(shards[1])
    assert shards[0] | shards[1] == {f"v{i}" for i in range(7)}
    for pid, r in enumerate(results):
        assert r["mine"] == [f"v{i}" for i in range(7)][pid::2]
        # both processes see the global totals: 7 videos, 70 frames
        assert r["total"] == {"frames": 70.0, "videos": 7.0}
        assert r["psum"] == {"frames": 70.0, "videos": 2.0}
        assert r["mesh"] == [2, 1] and r["mesh2"] == [1, 2]
        # P("data")'s layout: a contiguous block of the leading axis
        assert r["x"] == list(range(8 * pid, 8 * pid + 8)) == r["y"]
        assert r["w"] == [1.0, 1.0, 1.0]  # rank 0's values everywhere
        assert r["x2"] == [0, 1, 2, 3]  # one data rank holds the whole batch


def test_make_mesh_refuses_an_uneven_model_split():
    from vdetlib_tpu_torch.dist import make_mesh

    with pytest.raises(ValueError, match="not divisible by model_parallel=4"):
        make_mesh(6, model_parallel=4)


def test_one_process_without_an_address_starts_nothing(monkeypatch):
    from vdetlib_tpu_torch.dist.multihost import (allreduce_metrics, init_multihost,
                                                 process_video_shard)

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not init_multihost() and not dist.is_initialized()
    assert process_video_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert allreduce_metrics({"a": 1, "b": np.float32(2.5)}) == {"a": 1.0, "b": 2.5}
    with pytest.raises(ValueError, match="RANK"):
        init_multihost("127.0.0.1:1", num_processes=2)


# ---------------------------------------------------------------- the sharded pipeline

PIPE_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, ".")
from tests.test_torch_multihost import pipe_inputs, tiny_pipeline_parts
from vdetlib_tpu_torch.dist import make_mesh, replicate
from vdetlib_tpu_torch.dist.multihost import init_multihost
from vdetlib_tpu_torch.pipeline.fused import FusedPipeline, make_sharded_pipeline

torch.set_num_threads(2)
port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
det, trk, trk_cfg, cfg = tiny_pipeline_parts()
mesh = make_mesh()
replicate(mesh, [det, trk])
frames, rois, t_valid, roi_mask = pipe_inputs(4)
sharded = make_sharded_pipeline(det, trk, trk_cfg, cfg, mesh)
got = sharded(torch.from_numpy(frames), torch.from_numpy(rois), t_valid,
              torch.from_numpy(roi_mask))
res = {"sharded": got._asdict()}
if pid == 0:
    single = FusedPipeline(det, trk, trk_cfg, cfg)
    res["single"] = [single(torch.from_numpy(frames[v]), torch.from_numpy(rois[v]), t_valid[v],
                            torch.from_numpy(roi_mask[v]))._asdict() for v in range(4)]
torch.save(res, out)
try:  # V must divide by the data size
    sharded(torch.from_numpy(frames[:3]), torch.from_numpy(rois[:3]))
except ValueError as e:
    assert "not divisible" in str(e)
else:
    raise AssertionError("3 snippets over 2 ranks did not raise")
dist.destroy_process_group()
"""

PIPE_T, PIPE_HW, PIPE_R, PIPE_C = 8, (96, 128), 12, 4


def tiny_pipeline_parts(seed=0):
    """Random tiny float32 nets (seeded) and a small fused config."""
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.tracker_net import TrackerConfig
    from vdetlib_tpu_torch.pipeline.fused import FusedConfig
    from vdetlib_tpu_torch.weights import init_detector, init_tracker

    det = init_detector(detector_preset("tiny", num_classes=PIPE_C, dtype=torch.float32),
                        torch.Generator().manual_seed(seed), device="cpu")
    det.head.dtype = det.head.fc0.dtype = torch.float32
    trk_cfg = TrackerConfig(dtype=torch.float32)
    trk = init_tracker(trk_cfg, torch.Generator().manual_seed(seed + 1), device="cpu")
    cfg = FusedConfig(image_hw=PIPE_HW, detect_batch=4, feat_batch=4, anchors_per_round=2,
                      max_tracks=4, max_paths=8, det_budget=16, out_budget=16,
                      score_thresh=0.2, anchor_thresh=0.26)
    return det, trk, trk_cfg, cfg


def pipe_inputs(V):
    """V synthetic snippets of PIPE_T frames (the third with a padded tail)
    with a varying proposal count a frame."""
    from vdetlib_tpu_torch.data.synth import SynthConfig, make_video

    frames, rois, masks = [], [], []
    for v in range(V):
        sv = make_video(SynthConfig(num_frames=PIPE_T, height=PIPE_HW[0], width=PIPE_HW[1],
                                    num_classes=PIPE_C, seed=20 + v))
        rng = np.random.default_rng(v)
        r = np.zeros((PIPE_T, PIPE_R, 4), np.float32)
        m = np.zeros((PIPE_T, PIPE_R), bool)
        for t in range(PIPE_T):
            k = rng.integers(0, sv.gt_boxes.shape[0], PIPE_R)
            r[t] = np.clip(sv.gt_boxes[k, t] + rng.normal(0, 4, (PIPE_R, 4)), 0,
                           [PIPE_HW[1] - 1, PIPE_HW[0] - 1] * 2)
            m[t, : PIPE_R - rng.integers(0, 5)] = True
        frames.append(sv.frames)
        rois.append(r)
        masks.append(m)
    t_valid = [PIPE_T] * V
    if V > 2:
        t_valid[2] = PIPE_T - 2
    return np.stack(frames), np.stack(rois), t_valid, np.stack(masks)


def test_sharded_pipeline_equals_single_calls(tmp_path):
    """V = 4 snippets over 2 ranks: every rank holds all 4 outputs, equal bit
    for bit to 4 single FusedPipeline calls."""
    outs = [str(tmp_path / f"pipe{i}.pt") for i in range(2)]
    _launch_pair(lambda port, i: [sys.executable, "-c", PIPE_WORKER, str(port), str(i),
                                  outs[i]], timeout=300)
    r0, r1 = (torch.load(o) for o in outs)
    single = r0["single"]
    assert int(sum(s["n_tracks"] for s in single)) > 0
    assert any(bool((s["path_ids"] >= 0).any()) for s in single)
    for name, got in r0["sharded"].items():
        assert got.shape[0] == 4, name
        assert torch.equal(got, r1["sharded"][name]), name
        for v in range(4):
            assert got[v].dtype == single[v][name].dtype, name
            assert torch.equal(got[v], single[v][name]), (name, v)
    assert r0["sharded"]["n_tracks"].shape == (4,)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, destroyed after the test."""
    for attempt in range(3):
        try:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    world_size=1, rank=0)
            break
        except Exception:  # the probed port was taken: try another
            if attempt == 2:
                raise
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_pipeline_matches_jax(one_rank_group):
    """One rank of the port's make_sharded_pipeline against JAX's on conftest's
    CPU mesh (2 of its 8 devices), V = 2, float32 nets: the North star bounds
    of tests/test_torch_fused.py, video by video."""
    import jax.numpy as jnp

    from tests.test_torch_fused import _cfg, _compare, _inputs
    from tests.torch_fused_common import f32_nets
    from vdetlib_tpu.dist.sharding import make_mesh as j_make_mesh
    from vdetlib_tpu.dist.sharding import replicate as j_replicate
    from vdetlib_tpu.pipeline import fused as jfused
    from vdetlib_tpu_torch.dist import make_mesh
    from vdetlib_tpu_torch.pipeline import fused as tfused

    n = f32_nets()
    inputs = [_inputs(seed) for seed in (11, 12)]
    frames = np.stack([f for f, _, _ in inputs])
    rois = np.stack([r for _, r, _ in inputs])
    jmesh = j_make_mesh(2)
    jfn = jfused.make_sharded_pipeline(n.jdet, n.jtrk, n.jtrk_cfg, _cfg(jfused), jmesh)
    with jmesh:
        want = jfn(j_replicate(jmesh, n.jdp), j_replicate(jmesh, n.jtp), jnp.asarray(frames),
                   jnp.asarray(rois))
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    mesh = make_mesh()
    assert mesh.shape == (1, 1)
    got = tfused.make_sharded_pipeline(n.tdet, n.ttrk, n.ttrk_cfg, _cfg(tfused), mesh)(
        torch.from_numpy(frames), torch.from_numpy(rois))
    got = {k: v.numpy() for k, v in got._asdict().items()}
    assert got["n_tracks"].shape == want["n_tracks"].shape == (2,)
    assert int(want["n_tracks"].min()) > 0
    for v in range(2):
        _compare({k: x[v] for k, x in got.items()}, {k: x[v] for k, x in want.items()})


# ---------------------------------------------------------------- the sharded train step

TRAIN_WORKER = r"""
import sys
import torch, torch.distributed as dist
sys.path.insert(0, ".")
from tests.test_torch_multihost import train_batch, train_parts
from vdetlib_tpu_torch.dist import make_mesh, shard_batch
from vdetlib_tpu_torch.dist.multihost import init_multihost
from vdetlib_tpu_torch.nn.train import train_step

torch.set_num_threads(2)
port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
model, opt = train_parts()
mesh = make_mesh()
terms = train_step(model, opt, shard_batch(mesh, train_batch()), mesh=mesh)
torch.save({"terms": terms,
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "params": {k: p.detach() for k, p in model.named_parameters()}}, out)
dist.destroy_process_group()
"""


def train_parts(seed=0):
    """The tiny detector in float32 (seeded) and its optimizer."""
    from vdetlib_tpu_torch.nn.presets import detector_preset
    from vdetlib_tpu_torch.nn.train import make_optimizer
    from vdetlib_tpu_torch.weights import init_detector

    model = init_detector(detector_preset("tiny", num_classes=3, dtype=torch.float32),
                          torch.Generator().manual_seed(seed), device="cpu")
    model.head.dtype = model.head.fc0.dtype = torch.float32
    return model, make_optimizer(model.parameters(), lr=1e-3)


def train_batch():
    """B = 4 images of 32×32, 6 ROIs each: the first rank's shard (images 0,
    1) holds 7 foreground ROIs and 12 valid ones, the second's (2, 3) 2 and
    9, so a mean of per-rank means is not the batch's mean."""
    rng = np.random.default_rng(0)
    labels = np.array([[1, 2, 1, 0, 1, 2],
                       [1, 2, 0, 0, 0, 0],
                       [0, 0, 1, 0, -1, -1],
                       [0, 2, 0, 0, 0, -1]], np.int32)
    rois = rng.uniform(0, 14, (4, 6, 2)).astype(np.float32)
    rois = np.concatenate([rois, rois + rng.uniform(6, 16, (4, 6, 2))], -1).astype(np.float32)
    return {
        "images_u8": torch.from_numpy(rng.integers(0, 255, (4, 32, 32, 3), dtype=np.uint8)),
        "rois": torch.from_numpy(rois),
        "labels": torch.from_numpy(labels),
        "bbox_targets": torch.from_numpy(rng.normal(0, 0.3, (4, 6, 4)).astype(np.float32)),
    }


def test_sharded_train_step_equals_one_process(tmp_path):
    from vdetlib_tpu_torch.nn.train import train_step

    batch = train_batch()
    fg = (batch["labels"] > 0).sum(1)
    assert fg[:2].sum() != fg[2:].sum()  # the shards' foreground counts differ
    outs = [str(tmp_path / f"train{i}.pt") for i in range(2)]
    _launch_pair(lambda port, i: [sys.executable, "-c", TRAIN_WORKER, str(port), str(i),
                                  outs[i]], timeout=300)
    r0, r1 = (torch.load(o) for o in outs)
    model, opt = train_parts()
    want_terms = train_step(model, opt, batch)
    for name, p in model.named_parameters():
        w = p.grad
        for r in (r0, r1):
            err = float((r["grads"][name] - w).abs().max())
            assert err <= 1e-4 * max(float(w.abs().max()), 1e-12), (name, err)
        # the parameters after the step are the same on both ranks, bit for bit
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    for k in ("loss", "cls_loss", "reg_loss", "n_fg"):
        for r in (r0, r1):
            assert float(r["terms"][k]) == pytest.approx(float(want_terms[k]), rel=1e-5), k
    assert int(r0["terms"]["n_fg"]) == int(fg.sum()) == 9


def test_sharded_step_keeps_gradients_in_one_buffer(one_rank_group):
    """With a mesh the gradients are views of one buffer that later steps
    reuse; two steps on a one-rank group equal two plain steps bit for bit,
    and allreduce_grads after a plain backward keeps the gradients' values."""
    from vdetlib_tpu_torch.dist import make_mesh
    from vdetlib_tpu_torch.nn.train import allreduce_grads, loss_and_terms, train_step

    mesh, batch = make_mesh(), train_batch()
    model, opt = train_parts()
    plain, plain_opt = train_parts()
    train_step(model, opt, batch, mesh=mesh)
    first = [p.grad for p in model.parameters()]
    assert len({g.untyped_storage().data_ptr() for g in first}) == 1
    train_step(model, opt, batch, mesh=mesh)
    assert all(p.grad is g for p, g in zip(model.parameters(), first))
    for _ in range(2):
        train_step(plain, plain_opt, batch)
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name

    fresh, _ = train_parts()
    loss_and_terms(fresh, batch)[0].backward()
    want = [p.grad.clone() for p in fresh.parameters()]
    allreduce_grads(fresh, mesh.get_group("data"))
    assert len({p.grad.untyped_storage().data_ptr() for p in fresh.parameters()}) == 1
    for p, w in zip(fresh.parameters(), want):
        assert torch.equal(p.grad, w)


# ---------------------------------------------------------------- pipeline --multihost

TOOL_FLAGS = ["--model", "tiny", "--num_classes", "4", "--image_hw", "96", "128",
              "--max_rois", "16", "--batch_size", "4", "--anchor_thresh", "0.26",
              "--engine", "fused", "--device", "cpu", "--eval"]

TOOL_WORKER = r"""
import os, sys
import torch
port, pid, data, work = sys.argv[1:5]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE="2", RANK=pid)
torch.set_num_threads(2)
from vdetlib_tpu_torch.cli.pipeline_tool import main
raise SystemExit(main([data, work, *sys.argv[5:], "--multihost"]))
"""


def test_pipeline_multihost_eval_equals_one_process(tmp_path):
    """Two processes sweep disjoint shards of a gen_synth set into one
    workdir; rank 0 evaluates every shard after the barrier, rank 1 prints
    no mAP. Each final.json equals a one-process sweep's byte for byte, and
    the mAP is the same."""
    import shutil

    from vdetlib_tpu_torch.cli import gen_synth, pipeline_tool

    data, work, one = tmp_path / "data", tmp_path / "work", tmp_path / "one"
    with contextlib.redirect_stdout(io.StringIO()):
        assert gen_synth.main([str(data), "--num_videos", "3", "--frames", "8", "--height",
                               "96", "--width", "128", "--proposals", "16"]) in (0, None)
    names = sorted(p.name[: -len(".vid.json")] for p in data.glob("*.vid.json"))
    assert len(names) == 3
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pipeline_tool.main([str(data), str(one), *TOOL_FLAGS]) == 0
    want_map = re.search(r"mAP = ([\d.]+) over 3 videos", out.getvalue()).group(1)
    logs = _launch_pair(
        lambda port, i: [sys.executable, "-c", TOOL_WORKER, str(port), str(i), str(data),
                         str(work), *TOOL_FLAGS],
        timeout=300, before_attempt=lambda: shutil.rmtree(work, ignore_errors=True))
    # each process ran its round-robin shard: rank 0 two videos, rank 1 one
    assert f"fused {names[0]}:" in logs[0] and f"fused {names[2]}:" in logs[0]
    assert f"fused {names[1]}:" in logs[1] and f"fused {names[0]}:" not in logs[1]
    # only rank 0 printed the global eval, over all three videos
    got_map = re.search(r"mAP = ([\d.]+) over 3 videos", logs[0]).group(1)
    assert got_map == want_map
    assert "mAP" not in logs[1]
    for name in names:
        for f in ("final.json", "tubelets.json"):
            assert (work / name / f).read_bytes() == (one / name / f).read_bytes(), (name, f)
