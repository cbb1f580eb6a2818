"""Build and bind the hand-written CUDA kernels of ``esvo_tpu_torch/csrc``.

Each ``.cu`` file has a plain ``extern "C"`` launcher. It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library at first use, under
``build/esvo_tpu_torch/`` at the repo root, named by a hash of its
source and flags, and loaded with ``ctypes``. All sources build in
parallel (one ``nvcc`` each). Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from esvo_tpu_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "esvo_tpu_torch"
# No --use_fast_math: 1/den, exp and floor stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ptxas register / shared-memory report of the last build, per source
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources) -> dict[str, Path]:
    """Compile every source whose library is missing, all at once, and
    return {source: library path}. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in sources}
    missing = [s for s, out in paths.items() if not out.exists()]
    if not missing:
        return paths
    failed = []
    with span("kernel.build", sources=missing):
        procs = {}
        for s in missing:
            out = paths[s]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
            procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
        for s, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[s] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {s}:\n{log}")
                continue
            os.replace(tmp, out)
        count("kernel.builds", len(missing))
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build([source])[source]))
        _LIBS[source] = lib
    return lib


class CudaKernel:
    """One launcher of one source file, with its launch counts.

    ``launches`` counts the calls of :meth:`launch` that handed a kernel
    to the card (the plain twins never touch it). ``replayed`` counts
    the launches inside replays of a CUDA graph whose replayer adds them
    (``MappingCycle.working_cycle``: what :func:`launch_counts` saw its
    capture record, once a replay); ``ResidentLoop``'s replays are
    counted from the profiler's kernel records instead."""

    every: list = []      # each wrapper made, for launch_counts

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self.replayed = 0
        self._fn = None
        CudaKernel.every.append(self)

    def launch(self, *args) -> None:
        """Call the launcher on PyTorch's current stream; tensors pass as
        their device pointers. Raises on a non-zero CUDA error."""
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err} ({self.source})")
        self.launches += 1


def launch_counts() -> dict:
    """Each kernel wrapper's ``launches`` so far."""
    return {k: k.launches for k in CudaKernel.every}


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """The checks every wrapper makes before it hands a pointer over."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
