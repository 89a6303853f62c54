"""Build the hand-written CUDA kernels of ``csrc/`` at first use; load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` into ``_build/lib<name>-<hash>.so`` (seconds, against minutes
for a source that includes PyTorch's headers). The hash covers the source,
the ``csrc/`` headers it includes (``#include "x.cuh"``) and the flags, so an
edited kernel or header rebuilds and an unchanged one is reused;
delete ``vdetlib_tpu_torch/_build/`` to force a rebuild. Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

# every kernel's C entry point: name → (ctypes argtypes); restype is c_int
# (the cudaGetLastError() code after the launch)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNELS = {
    # flow_level(i1, i2, out, P, H, W, tile_h, search, radius, temperature, stream)
    "flow_level": (("vdet_flow_level", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P)), ()),
    # nms_grouped(boxes, scores, valid, groups, keep, B, N, thresh, offset, stream).
    # No FMA contraction: keep sets are threshold decisions on an IoU whose
    # op order must round exactly like the reference's.
    "nms_grouped": (
        ("vdet_nms_grouped", (_P, _P, _P, _P, _P, _I, _I, _F, _F, _P)),
        ("-fmad=false",),
    ),
    # nms_batched(boxes, scores, valid, keep, B, N, thresh, offset, stream)
    "nms_batched": (
        ("vdet_nms_batched", (_P, _P, _P, _P, _I, _I, _F, _F, _P)),
        ("-fmad=false",),
    ),
    # nms_sorted(sorted_boxes, sorted_valid, sorted_keep, B, N, thresh, offset, stream)
    "nms_sorted": (
        ("vdet_nms_sorted", (_P, _P, _P, _I, _I, _F, _F, _P)),
        ("-fmad=false",),
    ),
    # resize_normalize(frames, ylo, yhi, wylo, wyhi, xlo, xhi, wxlo, wxhi, out,
    # B, H, W, Ho, Wo, mean0, mean1, mean2, scale, stream); products and sums
    # round once each, in the plain version's order
    "resize_normalize": (
        ("vdet_resize_normalize", (_P,) * 10 + (_I,) * 5 + (_F,) * 4 + (_P,)),
        ("-fmad=false",),
    ),
    # track_scan(feats, feats_bf16, anchor_ts, anchor_boxes, templates, out_box,
    # out_conf, out_alive, T, A, h, w, C, Q, P, stride, factor, conf_thresh,
    # n_cta, parts, stream); the window, bilinear weights and box update round
    # as the plain version's ops do
    "track_scan": (
        ("vdet_track_scan", (_P, _I, _P, _P, _P, _P, _P, _P) + (_I,) * 8 + (_F, _F, _I, _I, _P)),
        ("-fmad=false",),
    ),
}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built on a "
            "machine with the CUDA toolkit"
        )
    return found


def _sources(path: Path, seen=None) -> list[Path]:
    """``path`` and the ``csrc/`` headers it includes, transitively."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC_DIR / inc.decode()
            if dep.is_file():
                _sources(dep, seen)
    return seen


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library lives for the current sources."""
    (_, extra) = KERNELS[name]
    h = hashlib.sha256()
    for src in _sources(CSRC_DIR / f"{name}.cu"):
        h.update(src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source exists."""
    so = library_path(name)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (_, extra) = KERNELS[name]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{res.stdout}\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


def build_all() -> dict[str, Path]:
    """Build every kernel at once: one ``nvcc`` per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


@functools.lru_cache(maxsize=None)
def load(name: str):
    """Build (if needed) and load kernel ``name``; returns its typed C function."""
    ((symbol, argtypes), _) = KERNELS[name]
    lib = ctypes.CDLL(str(build(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_log(name: str) -> str:
    """ptxas report of the last build of ``name`` (empty if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
