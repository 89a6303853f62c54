"""The port imports neither JAX nor the JAX package: every module of
vdetlib_tpu_torch and chip_smoke.py load in a process where jax, flax, optax,
orbax and vdetlib_tpu cannot be imported, and no source file of the package
(nor chip_smoke.py) names them in an import statement."""

import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "vdetlib_tpu_torch"
MODULES = sorted(
    "vdetlib_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)
# the card's smoke script
EXTRA = ["chip_smoke"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "vdetlib_tpu")

_BLOCKER = """
import importlib, sys

BLOCKED = %r

class _Block:
    # "vdetlib_tpu_torch".split(".")[0] is not "vdetlib_tpu": the port loads
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import vdetlib_tpu_torch
for m in sys.argv[1:]:
    importlib.import_module(m)
assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
print("ok", len(sys.argv) - 1)
""" % (BLOCKED,)


def test_slice_modules_listed():
    """The package holds every module of the slice (a rename would hide one)."""
    for m in (
        "geometry.boxes", "nn.backbone", "nn.heads", "nn.detector", "nn.presets",
        "nn.tracker_net", "video.detect", "video.mgp", "video.track", "video.rescore",
        "video.link", "kernels.flow", "kernels.flow_level", "kernels.nms",
        "kernels.nms_grouped", "kernels.seq_nms", "kernels.build", "pipeline.fused",
        "weights", "kernels.nms_batched", "kernels.nms_sorted", "video.stream",
        "video.frame_nms", "cli.stream", "cli.frame_nms", "protos.codec", "protos.accessors",
        "protos.arrays", "data.synth", "data.loader", "utils.log", "__main__",
        "kernels.preprocess", "kernels.track_scan", "cli.detect", "cli.track", "utils.common",
        "pipeline.checkpoint", "pipeline.runner", "pipeline.fused_runner", "dist.sharding",
        "evaluation.vid_map", "evaluation.calibration", "video.perturb", "cli.pipeline_tool",
        "kernels.seq_nms_host", "utils.prng", "cli.mgp", "cli.rescore", "cli.seq_nms",
        "nn.train", "nn.tracker_train", "cli.train_detector", "cli.train_tracker",
        "cli.serve", "evaluation.submission", "cli.eval_vid", "cli.write_submission",
        "cli.calibrate", "cli.gen_vid_proto", "video.proposal", "cli.gen_box_proto",
        "data.vid_dataset", "cli.import_vid", "cli.gen_synth", "utils.visual", "cli.show",
        "utils.flops", "utils.profiling", "dist.multihost",
    ):
        assert "vdetlib_tpu_torch." + m in MODULES, m


def test_imports_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *MODULES, *EXTRA],
        capture_output=True, text=True, cwd=PKG.parent, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == f"ok {len(MODULES) + len(EXTRA)}"


# an entry point and what it imports when it runs (its lazy imports), each
# loaded alone: the staged runner chains every stage of video/
ENTRY_POINTS = {
    "staged_runner": ["vdetlib_tpu_torch.pipeline.runner"],
    "pipeline_tool": ["vdetlib_tpu_torch.cli.pipeline_tool", "vdetlib_tpu_torch.dist.sharding",
                      "vdetlib_tpu_torch.dist.multihost",
                      "vdetlib_tpu_torch.nn.presets", "vdetlib_tpu_torch.pipeline.checkpoint",
                      "vdetlib_tpu_torch.pipeline.fused_runner", "vdetlib_tpu_torch.weights",
                      "vdetlib_tpu_torch.evaluation.vid_map",
                      "vdetlib_tpu_torch.evaluation.calibration"],
    "train_detector": ["vdetlib_tpu_torch.cli.train_detector", "vdetlib_tpu_torch.nn.train",
                       "vdetlib_tpu_torch.video.detect", "vdetlib_tpu_torch.kernels.nms",
                       "vdetlib_tpu_torch.evaluation.vid_map",
                       "vdetlib_tpu_torch.pipeline.checkpoint"],
    "train_tracker": ["vdetlib_tpu_torch.cli.train_tracker", "vdetlib_tpu_torch.nn.tracker_train",
                      "vdetlib_tpu_torch.pipeline.checkpoint"],
    "serve": ["vdetlib_tpu_torch.cli.serve", "vdetlib_tpu_torch.nn.presets",
              "vdetlib_tpu_torch.pipeline.checkpoint", "vdetlib_tpu_torch.pipeline.runner",
              "vdetlib_tpu_torch.pipeline.fused_runner", "vdetlib_tpu_torch.weights",
              "vdetlib_tpu_torch.kernels.build"],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_imports_with_jax_blocked(name):
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *ENTRY_POINTS[name]],
        capture_output=True, text=True, cwd=PKG.parent, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == f"ok {len(ENTRY_POINTS[name])}"


# the JAX packages whose __init__ exports names
PACKAGES = ("protos", "geometry", "kernels", "evaluation", "nn", "dist")


def _exported(init_path: pathlib.Path) -> set:
    """The names an ``__init__.py`` imports from its modules (its exports)."""
    import ast

    tree = ast.parse(init_path.read_text())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            and node.module and node.module.startswith("vdetlib_tpu")
            for a in node.names}


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_every_name_of_the_jax_package(package):
    """Each package ``__init__`` of the port exports every name its JAX
    counterpart exports; importing them builds no kernel (``_build`` gains
    nothing)."""
    import importlib

    want = _exported(PKG.parent / "vdetlib_tpu" / package / "__init__.py")
    assert want, package
    missing = want - _exported(PKG / package / "__init__.py")
    assert not missing, (package, sorted(missing))
    mod = importlib.import_module(f"vdetlib_tpu_torch.{package}")
    assert all(callable(getattr(mod, n)) or isinstance(getattr(mod, n), float)
               for n in want), package


def test_reexports_build_nothing():
    code = ("import pathlib, vdetlib_tpu_torch.kernels.build as b; "
            "before = set(b.BUILD_DIR.glob('*')) if b.BUILD_DIR.exists() else set(); "
            "import vdetlib_tpu_torch.kernels, vdetlib_tpu_torch.protos, "
            "vdetlib_tpu_torch.evaluation, vdetlib_tpu_torch.nn, vdetlib_tpu_torch.dist, "
            "vdetlib_tpu_torch.geometry; "
            "after = set(b.BUILD_DIR.glob('*')) if b.BUILD_DIR.exists() else set(); "
            "assert after == before, after - before; "
            "assert not b._load.cache_info().currsize; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_dispatcher_lists_the_jax_tools():
    """``python -m vdetlib_tpu_torch`` lists JAX's 20 tools, each module has a
    ``main``, and the show tools take their name as ``tool``."""
    import importlib
    import inspect

    from vdetlib_tpu.cli import TOOLS as JAX_TOOLS
    from vdetlib_tpu_torch.__main__ import TOOLS

    res = subprocess.run([sys.executable, "-m", "vdetlib_tpu_torch"], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    listed = re.search(r"^tools: (.*)$", res.stdout, re.M).group(1).split(", ")
    assert listed == sorted(JAX_TOOLS) == sorted(TOOLS)
    assert len(listed) == 20
    for tool, mod in TOOLS.items():
        assert mod == JAX_TOOLS[tool].replace("vdetlib_tpu.", "vdetlib_tpu_torch.", 1)
        params = inspect.signature(importlib.import_module(mod).main).parameters
        assert ("tool" in params) == tool.startswith("show_"), tool


def test_staged_runner_imports_the_stages():
    """The runner's stage functions are the port's own (video/*)."""
    from vdetlib_tpu_torch.pipeline import runner

    for fn in (runner.det_vid, runner.mgp, runner.track_from_det,
               runner.perturb_rescore_track_proto, runner.tubelet_rescore,
               runner.seq_nms_video, runner.FrameLoader, runner.proto_dump):
        assert fn.__module__.startswith("vdetlib_tpu_torch."), fn


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"],
                         ids=lambda p: p.name)
def test_no_jax_import_statement(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", src, re.M), path
    # the JAX package itself ("vdetlib_tpu_torch" has no word boundary there)
    assert not re.search(r"^\s*(import|from)\s+vdetlib_tpu\b", src, re.M), path


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the smoke script exits nonzero and prints no
    result, from the repository and from a directory holding only itself."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(PKG.parent / "chip_smoke.py", alone)
    for script, cwd in ((PKG.parent / "chip_smoke.py", PKG.parent), (alone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=cwd, timeout=120)
        assert res.returncode != 0 and res.stdout == "", (script, res.stdout, res.stderr)
