"""Build the hand-written CUDA kernels of ``csrc/`` at first use; load them with ctypes.

The host library ``csrc/nms_host.cpp`` (the frame-NMS tool's greedy NMS)
is built the same way with ``g++``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` into ``_build/lib<name>-<hash>.so`` (seconds, against minutes
for a source that includes PyTorch's headers). The hash covers the source,
the ``csrc/`` headers it includes (``#include "x.cuh"``) and the flags, so an
edited kernel or header rebuilds and an unchanged one is reused;
delete ``vdetlib_tpu_torch/_build/`` to force a rebuild. Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``.

A kernel that cannot be built or launched raises :class:`KernelError`, a
``RuntimeError`` of its own so that a caller that survives other errors
(the serving daemon) can let this one through.

Threads of one process (the staged runner's ``workers``) may ask for the
same kernel at once: each kernel has a lock that ``build`` holds from its
existence check to its rename and ``load`` holds around its first call, so
one ``nvcc`` runs and every caller gets its library. Across processes the
temporary file carries the process and thread ids and the rename is
atomic, so a loader never sees a partial library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

class KernelError(RuntimeError):
    """A hand-written kernel could not be built (no toolkit, ``nvcc`` failed)
    or its launch returned a CUDA error."""


# every kernel's C entry point: name → (ctypes argtypes); restype is c_int
# (the cudaGetLastError() code after the launch)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNELS = {
    # flow_level(i1, i2, out, f32, P, H, W, tile_h, search, radius, temperature,
    # stream); f32 = 1: float32 inputs, 0: bf16
    "flow_level": (("vdet_flow_level", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P)), ()),
    # nms_grouped(boxes, scores, valid, groups, keep, B, N, threads, thresh,
    # offset, stream). No FMA contraction: keep sets are threshold decisions
    # on an IoU whose op order must round exactly like the reference's.
    "nms_grouped": (
        ("vdet_nms_grouped", (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P)),
        ("-fmad=false",),
    ),
    # nms_batched(boxes, scores, valid, keep, B, N, threads, thresh, offset, stream)
    "nms_batched": (
        ("vdet_nms_batched", (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P)),
        ("-fmad=false",),
    ),
    # nms_sorted(boxes, scores, valid, keep, B, N, threads, thresh, offset, stream)
    "nms_sorted": (
        ("vdet_nms_sorted", (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P)),
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
    # seq_nms(scores, mask, link, over, out, pid, alive, path, bp, C, T, N,
    # max_paths, rescore_max, stream); dp adds and the statistic round as the
    # plain version's ops do
    "seq_nms": (
        ("vdet_seq_nms", (_P,) * 9 + (_I,) * 5 + (_P,)),
        ("-fmad=false",),
    ),
}

# host libraries (plain C++, built with g++), in KERNELS' layout. No
# -march=native (the JAX package's Makefile has it): a library in _build/
# may be reused on another machine; ISO C++ keeps FMA contraction off either
# way, so the arithmetic is the same.
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
HOST_LIBS = {
    # nms(dets (n, 5) float32, n, thresh, offset, keep_out (n,) int32) -> kept
    "nms_host": (("vdet_nms", (_P, _I, _F, _F, _P)), ()),
}

# one lock a library, reentrant: ``load`` holds it around ``build``
_LOCKS = {name: threading.RLock() for name in (*KERNELS, *HOST_LIBS)}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built on a "
            "machine with the CUDA toolkit"
        )
    return found


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise KernelError("g++ not found (set CXX): the host NMS library is built at first use")
    return found


def _spec(name: str):
    """(source, (symbol, argtypes), compiler flags) of a kernel or host library."""
    if name in HOST_LIBS:
        entry, extra = HOST_LIBS[name]
        return CSRC_DIR / f"{name}.cpp", entry, HOST_FLAGS + extra
    entry, extra = KERNELS[name]
    return CSRC_DIR / f"{name}.cu", entry, NVCC_FLAGS + extra


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
    source, _, flags = _spec(name)
    h = hashlib.sha256()
    for src in _sources(source):
        h.update(src.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (``.cpp`` for a host library) unless a
    library for this exact source exists."""
    so = library_path(name)
    with _LOCKS[name]:
        if so.is_file():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        source, _, flags = _spec(name)
        compiler = cxx_path() if name in HOST_LIBS else nvcc_path()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelError(f"{Path(compiler).name} failed on csrc/{source.name}:\n"
                              f"{res.stdout}\n{res.stderr}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
        return so


def build_all() -> dict[str, Path]:
    """Build every kernel and host library at once: one compiler per source,
    all started together."""
    from concurrent.futures import ThreadPoolExecutor

    names = (*KERNELS, *HOST_LIBS)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str):
    """Build (if needed) and load kernel ``name``; returns its typed C function."""
    with _LOCKS[name]:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str):
    _, (symbol, argtypes), _ = _spec(name)
    so = build(name)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelError(f"cannot load kernel {name} from {so.name}: {e}") from e
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_log(name: str) -> str:
    """ptxas report of the last build of ``name`` (empty if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launch plans' input)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
