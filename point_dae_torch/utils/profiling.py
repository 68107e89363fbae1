"""Profiling and complexity utilities (port of
``point_dae_tpu/utils/profiling.py``; the reference's thop / ptflops call
sites, tools/runner_pretrain.py:17-19, 154-159).

``count_params`` counts a module's (or a state dict's) elements;
``cost_analysis`` counts a function's floating-point operations with
``torch.utils.flop_counter.FlopCounterMode`` (bytes accessed are not
counted there: NaN, as JAX returns where XLA has no count); ``trace`` writes
a ``torch.profiler`` trace, viewable in TensorBoard or Perfetto;
``StepTimer`` times steps on the host's clock after waiting for the card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch


def count_params(params) -> int:
    """Elements of a module's parameters, or of a dict / list of tensors."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel())


def cost_analysis(fn: Callable, *args) -> Dict[str, Any]:
    """Floating-point operations of one call ``fn(*args)`` (each multiply
    and add of a product counted, as XLA counts them): {"flops",
    "bytes_accessed" (NaN), "raw" (operations by operator)}."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    raw = {str(k): int(v) for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float("nan"), "raw": raw}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the CPU and CUDA activity of the block and write it as a
    Chrome trace (``trace-<pid>.json``) under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))


class StepTimer:
    """Per-step wall-clock times (the reference's batch_time meter): a lap
    given a result, or on a card, first waits for the card to finish."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self.laps = []

    def lap(self, result=None) -> float:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if isinstance(result, torch.Tensor):
            result.cpu()
        t = time.perf_counter()
        dt = t - self._t0
        self._t0 = t
        self.laps.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.laps) / max(len(self.laps), 1)
