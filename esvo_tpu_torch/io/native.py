"""ctypes bindings for the native event loader (native/event_loader.cpp),
the counterpart of esvo_tpu/io/native.py.

The library is compiled with ``g++`` at first use into
``build/esvo_tpu_torch/`` at the repo root (as ops/_build.py does for the
CUDA kernels), named by a hash of its source and flags, never next to the
source. Where there is no compiler, or no source, the loaders fall back
to the Python path of io/events.py; a compile that fails with a compiler
present raises, so a broken native path does not hide behind the Python
one. ``load_events_native`` / ``frame_events_native`` are drop-in
replacements for ``load_events_txt`` / ``frame_events``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from esvo_tpu_torch.io.events import EventArray, frame_events, load_events_txt
from esvo_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "event_loader.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.el_load_txt.restype = ctypes.c_void_p
    lib.el_load_txt.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.el_from_arrays.restype = ctypes.c_void_p
    lib.el_from_arrays.argtypes = [c_f64p, c_i32p, c_i32p, c_u8p,
                                   ctypes.c_int64]
    lib.el_size.restype = ctypes.c_int64
    lib.el_size.argtypes = [ctypes.c_void_p]
    lib.el_read.restype = None
    lib.el_read.argtypes = [ctypes.c_void_p, c_f64p, c_i32p, c_i32p, c_u8p]
    lib.el_frame.restype = None
    lib.el_frame.argtypes = [
        ctypes.c_void_p, c_f64p, ctypes.c_int64, ctypes.c_int64, c_i32p,
        c_i32p, ctypes.POINTER(ctypes.c_float), c_u8p, c_u8p, c_i32p]
    lib.el_free.restype = None
    lib.el_free.argtypes = [ctypes.c_void_p]
    return lib


class NativeLoader:
    """The native library of one source, built into `build_dir` at the
    first ``lib()`` call; the outcome (library or None) is kept, so a
    machine without g++ does not spawn a compiler on every call."""

    def __init__(self, build_dir=BUILD_DIR, source=SOURCE):
        self.build_dir = Path(build_dir)
        self.source = Path(source)
        self._lib: ctypes.CDLL | None = None
        self._probed = False

    def library_path(self) -> Path:
        text = self.source.read_bytes() + " ".join(CXX_FLAGS).encode()
        digest = hashlib.sha256(text).hexdigest()[:16]
        return self.build_dir / f"libevent_loader-{digest}.so"

    def _build(self) -> Path | None:
        if not self.source.exists():
            return None
        out = self.library_path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(self.source),
                                   "-o", str(tmp)],
                                  capture_output=True, text=True)
        except OSError:
            return None                              # no g++ on PATH
        if proc.returncode != 0:
            raise RuntimeError(
                f"native event_loader build failed:\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL | None:
        if not self._probed:
            self._probed = True
            path = self._build()
            if path is not None:
                self._lib = _bind(ctypes.CDLL(str(path)))
        return self._lib


DEFAULT_LOADER = NativeLoader()


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def load_events_native(path: str, max_events: int | None = None,
                       loader: NativeLoader | None = None) -> EventArray:
    """Fast events.txt loader; the Python parser where there is no native
    library."""
    lib = (loader or DEFAULT_LOADER).lib()
    if lib is None:
        return load_events_txt(path, max_events)
    n = ctypes.c_int64(0)
    h = lib.el_load_txt(path.encode(), max_events or 0, ctypes.byref(n))
    if not h:
        raise FileNotFoundError(path)
    try:
        N = n.value
        t = np.empty(N, np.float64)
        x = np.empty(N, np.int32)
        y = np.empty(N, np.int32)
        p = np.empty(N, np.uint8)
        lib.el_read(h, _ptr(t, ctypes.c_double), _ptr(x, ctypes.c_int32),
                    _ptr(y, ctypes.c_int32), _ptr(p, ctypes.c_uint8))
    finally:
        lib.el_free(h)
    return EventArray(t=t, x=x, y=y, p=p.astype(bool))


def frame_events_native(ev: EventArray, sync_times: np.ndarray,
                        capacity: int, loader: NativeLoader | None = None):
    """Native framing, with io.events.frame_events' output contract."""
    # the Python path's absolute-timestamp guard: el_frame casts t to
    # float32, whose resolution at epoch scale (~1.4e9 s) is ~128 s
    if len(ev.t) and abs(float(ev.t[0])) >= 1e6:
        raise ValueError(
            "frame_events_native: timestamps look absolute (t[0]="
            f"{float(ev.t[0]):.3e}); rebase first (EventArray.rebased()).")
    lib = (loader or DEFAULT_LOADER).lib()
    if lib is None:
        return frame_events(ev, sync_times, capacity)
    t64 = np.ascontiguousarray(ev.t, np.float64)
    x32 = np.ascontiguousarray(ev.x, np.int32)
    y32 = np.ascontiguousarray(ev.y, np.int32)
    p8 = np.ascontiguousarray(ev.p, np.uint8)
    h = lib.el_from_arrays(_ptr(t64, ctypes.c_double),
                           _ptr(x32, ctypes.c_int32),
                           _ptr(y32, ctypes.c_int32),
                           _ptr(p8, ctypes.c_uint8), len(ev))
    try:
        sync = np.ascontiguousarray(sync_times, np.float64)
        K = len(sync)
        x = np.zeros((K, capacity), np.int32)
        y = np.zeros((K, capacity), np.int32)
        t = np.zeros((K, capacity), np.float32)
        p = np.zeros((K, capacity), np.uint8)
        valid = np.zeros((K, capacity), np.uint8)
        dropped = np.zeros(K, np.int32)
        lib.el_frame(h, _ptr(sync, ctypes.c_double), K, capacity,
                     _ptr(x, ctypes.c_int32), _ptr(y, ctypes.c_int32),
                     _ptr(t, ctypes.c_float), _ptr(p, ctypes.c_uint8),
                     _ptr(valid, ctypes.c_uint8),
                     _ptr(dropped, ctypes.c_int32))
    finally:
        lib.el_free(h)
    return dict(x=x, y=y, t=t, p=p.astype(bool), valid=valid.astype(bool),
                dropped=dropped)
