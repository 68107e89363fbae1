"""Device-resident dataset cache for one card (port of
``point_dae_tpu/data/device_cache.py:93-233``).

The train set is uploaded to the device once, in ``device_cache_dtype``
(float16 by default: coordinate quantisation about 1e-3 on unit-sphere
clouds, below the noise every recipe's augmentation adds). Each epoch draws
a permutation on the device from a ``torch.Generator`` seeded from
``(seed, epoch)``; each batch is one on-device gather, cast to float32, so
steady-state epochs move nothing from the host. As in the JAX package,
``steps_per_epoch = floor(M / batch)`` (drop_last), where the streaming
loader of a fine-tune keeps the tail. Enable with
``dataset.train.others.device_cache: true``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logger import print_log

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


class DeviceCache:
    """(M, N, C) clouds held on the device; shuffled batches by
    ``set_epoch(e)`` then ``batch(step, batch_size)``."""

    def __init__(self, points: np.ndarray, dtype: torch.dtype = torch.float16,
                 seed: int = 0, device=None):
        if points.ndim != 3:
            raise ValueError(f"expected (M, N, C) clouds, got {points.shape}")
        self.device = resolve_device(device)
        self.seed = int(seed)
        t0 = time.time()
        self.data = torch.from_numpy(np.ascontiguousarray(points)).to(self.device, dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_seconds = time.time() - t0
        self.nbytes = self.data.numel() * self.data.element_size()
        self.perm: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.data.shape[0]

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self) // batch_size

    def set_epoch(self, epoch: int) -> None:
        """Draw this epoch's permutation on the device."""
        g = torch.Generator(device=self.device).manual_seed(self.seed * 9973 + int(epoch))
        self.perm = torch.randperm(len(self), generator=g, device=self.device)

    def batch(self, step: int, batch_size: int) -> torch.Tensor:
        """The ``step``-th (B, N, C) float32 batch of the current epoch: one
        gather on the device."""
        if self.perm is None:
            self.set_epoch(0)
        idx = self.perm[step * batch_size:(step + 1) * batch_size]
        return self.data.index_select(0, idx).float()


def build_device_cache(dataset, dtype: torch.dtype = torch.float16,
                       max_bytes: Optional[int] = None, seed: int = 0, device=None,
                       logger_name: str = "PointDAE") -> DeviceCache:
    """Read a map-style dataset's clouds once on the host and upload them.
    Raises when the set would take more than ``max_bytes`` on the device."""
    n = len(dataset)
    first = np.asarray(dataset[0]["points"])
    est = n * first.size * torch.empty((), dtype=dtype).element_size()
    if max_bytes is not None and est > max_bytes:
        raise ValueError(f"device cache: the train set takes {est / 2 ** 30:.2f} GiB as "
                         f"{dtype}, above device_cache_max_bytes "
                         f"({max_bytes / 2 ** 30:.2f} GiB)")
    t0 = time.time()
    clouds = np.stack([np.asarray(dataset[i]["points"], np.float32) for i in range(n)])
    cache = DeviceCache(clouds, dtype=dtype, seed=seed, device=device)
    print_log(f"[DeviceCache] cached {n} clouds ({cache.nbytes / 2 ** 30:.2f} GiB as "
              f"{str(dtype).replace('torch.', '')}) on {cache.device} in "
              f"{time.time() - t0:.1f}s (upload {cache.upload_seconds:.1f}s); "
              f"steady-state epochs run with zero host->device traffic",
              logger=logger_name)
    return cache
