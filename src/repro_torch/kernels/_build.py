"""Build, load and count the port's CUDA kernels, safely across threads.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds); the tensor-core kernels
share the Hopper helpers of ``csrc/hopper.cuh``. It is compiled for
``sm_90a`` at first use into ``build/repro_torch_kernels/`` at the root
of the checkout and bound through ``ctypes``. Nothing is built when a
module is imported.

The engine launches kernels from the simulated Lambda thread pool, so
the build, the load and every launch count go through one
``threading.Lock``: two threads never compile or load the same library
twice, and no count is lost.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.RLock()
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch. The engine lets
    it propagate: nothing reruns the work on another path."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def library_path(name: str) -> pathlib.Path:
    """Where the build of ``csrc/<name>.cu`` lives: named by the hash of
    the source, of every header in ``csrc/`` (``*.cuh``, which the sources
    share) and of the flags, so a stale build is never loaded."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> list[pathlib.Path]:
    """Compile each named kernel unless a build of its exact source exists,
    one ``nvcc`` per source, all started together. Each library is moved
    into place whole, so a half-written build is never loaded; the
    compiler's report (registers, shared memory, spills) is kept beside it
    as ``<library>.log``. Returns the libraries' paths in order."""
    with _LOCK:
        outs = [library_path(n) for n in names]
        todo = [(n, out) for n, out in zip(names, outs) if not out.exists()]
        if not todo:
            return outs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        try:
            for name, out in todo:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                jobs.append((name, out, tmp, proc))
            failed = []
            for name, out, tmp, proc in jobs:
                report, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {name}.cu:\n{report}")
                    continue
                out.with_suffix(".log").write_text(report)
                os.replace(tmp, out)
            if failed:
                raise KernelError("\n".join(failed))
        finally:
            for _, _, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return outs


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``bind(lib)`` declares its functions' argtypes and restype once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            bind(lib)
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise KernelError when a launch returned a CUDA error code."""
    if err:
        raise KernelError(f"{what} kernel launch failed: "
                          + lib.repro_cuda_error_string(err).decode())


def count_launch(wrapper, variant: str | None = None) -> None:
    """Add one to ``wrapper.launches``, the count a run reads to show that
    its path went through the kernel, and to
    ``wrapper.launches_by_variant[variant]`` where the wrapper has several
    kernels, so a run shows which one it took."""
    with _LOCK:
        wrapper.launches += 1
        if variant is not None:
            wrapper.launches_by_variant[variant] += 1


def reset_launches(wrapper) -> None:
    """Set ``wrapper.launches`` and every per-variant count to 0."""
    with _LOCK:
        wrapper.launches = 0
        for key in getattr(wrapper, "launches_by_variant", {}):
            wrapper.launches_by_variant[key] = 0


def tma_describable(t) -> bool:
    """Whether a TMA tensor map can describe ``t`` as it lies: a 16-byte
    aligned base, a contiguous last dim, and every other stride a positive
    multiple of 16 bytes. Reads only metadata (meta tensors do)."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(s > 0 and s % step == 0 for s in t.stride()[:-1]))
