"""ctypes bindings for the native IO/render library ``native/pointio.cpp``
(the port's counterpart of ``point_dae_tpu/data/native_io.py``).

The port compiles ``native/pointio.cpp`` with ``g++`` at first use into
``build/torch_native/libpointdae_native-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds) and writes nothing under
``native/``. A library that cannot be built or lacks a symbol raises: the
port has no silent numpy fallback for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "pointio.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
_SYMBOLS = ("pdae_load_npy_batch", "pdae_render_balls")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpointdae_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the native IO library is built at first use and needs "
                           "a C++ compiler (g++, or $CXX)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, SOURCE, "-o", tmp], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be
    built or lacks one of its two entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        missing = [s for s in _SYMBOLS if not hasattr(lib, s)]
        if missing:
            raise RuntimeError(f"{path} lacks {missing}")
        lib.pdae_load_npy_batch.restype = ctypes.c_int64
        lib.pdae_load_npy_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]
        lib.pdae_render_balls.restype = None
        lib.pdae_render_balls.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float]
        _lib = lib
        return lib


def load_npy_batch(paths: List[str], n_points: int, n_cols: int,
                   seed: int = 0, n_threads: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded native batch load of float32/64 .npy clouds into a
    (B, n_points, n_cols) buffer (a stored cloud of another size is
    subsampled or padded to n_points). Returns (batch, ok_mask)."""
    lib = library()
    b = len(paths)
    out = np.empty((b, n_points, n_cols), np.float32)
    ok = np.zeros(b, np.uint8)
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    lib.pdae_load_npy_batch(
        arr, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_points, n_cols, seed,
        n_threads, ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out, ok.astype(bool)


def render_balls(points: np.ndarray, colors: Optional[np.ndarray] = None,
                 h: int = 512, w: int = 512, radius: float = 6.0,
                 scale: Optional[float] = None) -> np.ndarray:
    """Z-buffered sphere-impostor render (role of visualizer/render_balls_so
    + show3d_balls.py). points: (N, 3) roughly unit-sphere normalized.
    Returns (h, w, 3) float32 image in [0, 1]."""
    lib = library()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = pts.shape[0]
    if colors is None:
        colors = np.tile(np.array([[0.4, 0.7, 1.0]], np.float32), (n, 1))
    colors = np.ascontiguousarray(colors, np.float32)
    if colors.shape != (n, 3):
        raise ValueError(f"colors {colors.shape} for {n} points, expected ({n}, 3)")
    img = np.zeros((h, w, 3), np.float32)
    lib.pdae_render_balls(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        ctypes.c_float(radius), ctypes.c_float(scale or 0.45 * min(h, w)),
        ctypes.c_float(w / 2.0), ctypes.c_float(h / 2.0))
    return img
