"""Device-resident dataset cache (port of
``point_dae_tpu/data/device_cache.py:49-233``).

The train set is uploaded to the device once, in ``device_cache_dtype``
(float16 by default: coordinate quantisation about 1e-3 on unit-sphere
clouds, below the noise every recipe's augmentation adds). Each epoch draws
a permutation on the device from a ``torch.Generator`` seeded from
``(seed, epoch)``; each batch is one on-device gather, cast to float32, so
steady-state epochs move nothing from the host. As in the JAX package,
``steps_per_epoch = floor(M / batch)`` (drop_last), where the streaming
loader of a fine-tune keeps the tail. Enable with
``dataset.train.others.device_cache: true``.

Under a process group the set is split by rows as the JAX package splits
it over its mesh: the M rows are wrap-padded to a multiple of the world
size and rank h holds the h-th contiguous block. The permutation is global
(every rank draws the same one); to serve a global batch each rank gathers
the rows it owns, with exact zeros elsewhere, one all-reduce sums the
blocks (bit for bit: each element has one non-zero contributor,
``parallel/mesh.py:exact_sum_of_disjoint``), and each rank keeps its
contiguous slice, the counterpart of the JAX ``psum_scatter`` gather.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh, exact_sum_of_disjoint, get_mesh, local_rows
from ..utils.device import resolve_device
from ..utils.logger import print_log

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


class DeviceCache:
    """(M, N, C) clouds held on the device; shuffled batches by
    ``set_epoch(e)`` then ``batch(step, batch_size)``."""

    def __init__(self, points: np.ndarray, dtype: torch.dtype = torch.float16,
                 seed: int = 0, device=None, total: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        if points.ndim != 3:
            raise ValueError(f"expected (M, N, C) clouds, got {points.shape}")
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.mesh = mesh or Mesh()
        # this rank's block of a wrap-padded set of ``total`` rows
        self.total = points.shape[0] if total is None else int(total)
        self.offset = self.mesh.rank * points.shape[0]
        t0 = time.time()
        self.data = torch.from_numpy(np.ascontiguousarray(points)).to(self.device, dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_seconds = time.time() - t0
        self.nbytes = self.data.numel() * self.data.element_size()
        self.perm: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.total

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self) // batch_size

    def set_epoch(self, epoch: int) -> None:
        """Draw this epoch's permutation on the device."""
        g = torch.Generator(device=self.device).manual_seed(self.seed * 9973 + int(epoch))
        self.perm = torch.randperm(len(self), generator=g, device=self.device)

    def batch(self, step: int, batch_size: int) -> torch.Tensor:
        """The ``step``-th (B, N, C) float32 batch of the current epoch
        (``batch_size`` the global batch): one gather on the device; under
        a process group this rank's contiguous B / world rows of it."""
        if self.perm is None:
            self.set_epoch(0)
        idx = self.perm[step * batch_size:(step + 1) * batch_size]
        if self.mesh.world == 1:
            return self.data.index_select(0, idx).float()
        loc = idx - self.offset
        own = (loc >= 0) & (loc < self.data.shape[0])
        rows = self.data.index_select(0, torch.where(own, loc, torch.zeros_like(loc)))
        rows = torch.where(own[:, None, None], rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))
        full = exact_sum_of_disjoint(self.mesh, rows)
        return full[local_rows(self.mesh, batch_size)].float()


def cache_rows(n: int, num_hosts: int = 1, host_id: int = 0) -> range:
    """The rows of an n-cloud set that rank ``host_id`` of ``num_hosts``
    holds: its contiguous block of the set wrap-padded to a multiple of
    ``num_hosts`` (row i of the padded set is cloud i % n)."""
    per = -(-n // num_hosts)
    return range(host_id * per, (host_id + 1) * per)


def build_device_cache(dataset, dtype: torch.dtype = torch.float16,
                       max_bytes: Optional[int] = None, seed: int = 0, device=None,
                       logger_name: str = "PointDAE",
                       mesh: Optional[Mesh] = None) -> DeviceCache:
    """Read a map-style dataset's clouds once on the host and upload them;
    under a process group each rank reads and uploads only its block
    (``cache_rows``). Raises when the block would take more than
    ``max_bytes`` on the device."""
    mesh = mesh or get_mesh()
    n = len(dataset)
    rows = cache_rows(n, mesh.world, mesh.rank)
    first = np.asarray(dataset[0]["points"])
    est = len(rows) * first.size * torch.empty((), dtype=dtype).element_size()
    if max_bytes is not None and est > max_bytes:
        raise ValueError(f"device cache: the train set takes {est / 2 ** 30:.2f} GiB as "
                         f"{dtype}, above device_cache_max_bytes "
                         f"({max_bytes / 2 ** 30:.2f} GiB)")
    t0 = time.time()
    clouds = np.stack([np.asarray(dataset[i % n]["points"], np.float32) for i in rows])
    cache = DeviceCache(clouds, dtype=dtype, seed=seed, device=device, total=n, mesh=mesh)
    print_log(f"[DeviceCache] cached {n} clouds (block {len(rows)}, "
              f"{cache.nbytes / 2 ** 30:.2f} GiB as "
              f"{str(dtype).replace('torch.', '')}) on {cache.device} in "
              f"{time.time() - t0:.1f}s (upload {cache.upload_seconds:.1f}s); "
              f"steady-state epochs run with zero host->device traffic",
              logger=logger_name)
    return cache
