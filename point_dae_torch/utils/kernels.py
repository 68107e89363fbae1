"""Build, load and count the port's hand-written CUDA kernels.

Each ``point_dae_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so`` at first use
(the hash covers the sources and flags, so an edited source rebuilds) and
loaded with ctypes. Nothing is built or loaded at import time: the CPU
tests import every module of the port on hosts without ``nvcc``.

``launches`` counts, per kernel wrapper, the launches made on the model's
path; ``chip_smoke.py`` zeroes it before a run and reads it after.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("patchify", "gather", "chamfer", "mlp", "folding", "attention",
           "edgeconv", "fps", "scatter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Dict[str, int] = {"patchify": 0, "gather_rows_small_c": 0,
                            "nn_half_small": 0, "mlp_ln_fwd": 0,
                            "mlp_ln_bwd": 0, "folding_fwd": 0,
                            "folding_bwd": 0, "attention_fwd": 0,
                            "attention_bwd": 0, "nn_half_tiled": 0,
                            "knn_aggregate_fwd": 0,
                            "knn_aggregate_bwd_first": 0,
                            "knn_aggregate_bwd_split": 0, "fps": 0,
                            "scatter_rows_add": 0, "key_gather": 0, "knn": 0,
                            "aggregate_from_idx": 0, "mlp_fwd": 0, "mlp_bwd": 0,
                            "gather_rows_wide": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of point_dae_torch "
                           "are built on first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed kernel library that is not built yet, one
    ``nvcc`` per source, all started together. Returns each compiled
    source's compiler output (``-Xptxas -v``: registers, spills, shared
    memory)."""
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for n in todo:
            out = _lib_path(n)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        logs = {}
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
            os.replace(tmp, out)
            logs[n] = log
        return logs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            lib.pdae_error_string.argtypes = [ctypes.c_int]
            lib.pdae_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(counter: str, lib_name: str, fn_name: str, argtypes, *args) -> None:
    """Call the C entry ``fn_name`` of library ``lib_name`` (its ctypes
    ``argtypes`` are set on first use), raise if it reports a CUDA error,
    and count the launch under ``counter``."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        lib = library(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    err = fn(*args)
    if err != 0:
        msg = library(lib_name).pdae_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: {msg} ({err})")
    launches[counter] += 1


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_cuda(*tensors: torch.Tensor, contiguous: bool = True) -> None:
    """Kernel inputs must be tensors on one CUDA device, contiguous unless
    the kernel reads them by their strides."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected one CUDA device")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()
