"""The kernel build under threads (``vdetlib_tpu_torch/kernels/build.py``).

Four threads of one process ask for the same kernel at once, as the staged
runner's ``workers`` do on a fresh checkout. ``nvcc`` is replaced by a fake
compiler that sleeps, writes the file named by ``-o`` and counts its calls;
``BUILD_DIR`` points at a temporary directory. Exactly one compile may run,
no thread may raise, and every thread must get the same library.
"""

import sys
import threading
import time
import types

import pytest

from vdetlib_tpu_torch.kernels import build

THREADS = 4


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    calls = []

    def run(cmd, capture_output=True, text=True):
        out = cmd[cmd.index("-o") + 1]
        calls.append(out)
        time.sleep(0.2)  # long enough for every thread to reach its check
        with open(out, "wb") as f:
            f.write(b"\x7fELF fake library")
        return types.SimpleNamespace(returncode=0, stdout="ptxas info: fake\n", stderr="")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    return calls


def _at_once(fn):
    """``fn()`` from THREADS threads released together, with a short switch
    interval so that the threads interleave: (results, errors)."""
    gate = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def one(i):
        gate.wait(timeout=30)
        try:
            results[i] = fn()
        except Exception as e:  # every failure is the finding
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    return results, errors


def test_concurrent_build_compiles_once(fake_nvcc):
    paths, errors = _at_once(lambda: build.build("flow_level"))
    assert errors == []
    assert len(fake_nvcc) == 1
    assert len(set(paths)) == 1 and paths[0] == build.library_path("flow_level")
    assert paths[0].read_bytes() == b"\x7fELF fake library"
    assert build.build_log("flow_level") == "ptxas info: fake\n"
    assert [p.name for p in paths[0].parent.iterdir() if p.name.endswith(".tmp")] == []


def test_concurrent_load_builds_and_opens_once(fake_nvcc, monkeypatch):
    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)
            time.sleep(0.05)
            self.vdet_flow_level = types.SimpleNamespace()

    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    cached = getattr(build, "_load", build.load)  # the lru_cache behind the lock
    cached.cache_clear()
    try:
        fns, errors = _at_once(lambda: build.load("flow_level"))
    finally:
        cached.cache_clear()
    assert errors == []
    assert len(fake_nvcc) == 1 and len(opened) == 1
    assert all(fn is fns[0] for fn in fns)
    assert fns[0].restype is build.ctypes.c_int


def test_kernel_errors_are_their_own_runtime_error(tmp_path, monkeypatch):
    """A failed launch, a failed ``nvcc`` and a missing toolkit raise
    ``KernelError``, still a ``RuntimeError``, with their messages."""
    assert issubclass(build.KernelError, RuntimeError)
    build.check_launch("flow_level", 0)  # a clean launch raises nothing
    with pytest.raises(build.KernelError,
                       match=r"^CUDA kernel nms_grouped failed to launch: cudaError 700$"):
        build.check_launch("nms_grouped", 700)

    def failing_nvcc(cmd, capture_output=True, text=True):
        return types.SimpleNamespace(returncode=1, stdout="out", stderr="error: bad")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", failing_nvcc)
    with pytest.raises(RuntimeError) as err:
        build.build("track_scan")
    assert type(err.value) is build.KernelError
    assert str(err.value) == "nvcc failed on csrc/track_scan.cu:\nout\nerror: bad"
    assert list((tmp_path / "_build").iterdir()) == []  # no partial library left
    monkeypatch.undo()

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(build.KernelError, match=r"^nvcc not found \(set CUDA_HOME\)"):
        build.nvcc_path()
