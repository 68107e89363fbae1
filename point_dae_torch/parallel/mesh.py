"""Process groups and data parallelism, one process per card (port of
``point_dae_tpu/parallel/mesh.py:1-117``).

The JAX package jits each step over a 1-D ``Mesh(('data',))`` and lets XLA
insert the collectives; the port runs one process per card and makes them
explicit:

- the batch is split by rows: each rank holds a contiguous slice of every
  global batch (``data/loader.py`` and ``data/device_cache.py`` take
  ``loader_shard_kwargs``), so the global batch is bitwise the one-process
  batch;
- every random draw of a step is drawn for the global batch from a
  generator seeded alike on every rank, and each rank keeps its rows
  (``draw_rows``): a cloud gets the draws it gets in one process, and a
  per-step scalar (a mask ratio, a batch-wide coin) is the same everywhere;
- the gradients' mean over ranks is taken before the clip
  (``engine/train_state.py``), one flattened all-reduce per dtype;
- each batch-wide statistic whose denominator depends on the data
  (BatchNorm's moments, a weighted mean's ``sum(w)``, the dVAE's mean
  token distribution) sums its parts over ranks through ``global_sum``,
  whose backward sums the ranks' upstream gradients too. With every rank's
  loss L_r so that the global loss is the ranks' mean, the rank's backward
  gives W times its rows' share of the global gradient (W the world size),
  and the mean over ranks is the global gradient;
- eval and probe loops split each (padded) batch by rows and gather the
  outputs (``sharded_eval``); checkpoints, logs and scalars are written by
  rank 0 alone.

Without a process group the world size is 1 and every helper is the
identity, so a one-process run is bit for bit what it was. Launch several
processes with ``torchrun --nproc_per_node=N main_torch.py ...``;
tensor parallelism (the JAX ``get_mesh_2d``, ``shard_params``) is not
ported.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group a process belongs to: ``world`` ranks, this one
    ``rank`` (``local_rank`` on its host), its ``device`` and the ``group``
    (None: no process group, one process)."""
    world: int = 1
    rank: int = 0
    local_rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_device: Optional[torch.device] = None
_local_rank = 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None,
                           timeout_s: float = 600.0,
                           init_method: Optional[str] = None) -> Mesh:
    """Form the process group (the role of ``jax.distributed.initialize``).

    Explicit arguments, or torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) where
    ``coordinator_address`` and ``init_method`` are not given.
    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL);
    ``init_method`` any URL ``init_process_group`` takes (``file://`` for a
    ``FileStore``). ``device`` defaults to ``cuda:LOCAL_RANK``; the backend
    is nccl on a card and gloo on the CPU. Raises if the group does not
    form within ``timeout_s``."""
    global _device, _local_rank
    env = os.environ
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    if init_method is None:
        if coordinator_address is None:
            init_method = "env://"
        else:
            init_method = coordinator_address if "://" in coordinator_address \
                else f"tcp://{coordinator_address}"
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s), **kw)
    _device, _local_rank = dev, local_rank
    return get_mesh()


def get_mesh() -> Mesh:
    """The current process group as a ``Mesh``; ``Mesh()`` (world 1, no
    group) when none was formed."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    return Mesh(dist.get_world_size(), dist.get_rank(), _local_rank, _device,
                dist.group.WORLD)


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(mesh: Optional[Mesh] = None) -> None:
    mesh = mesh or get_mesh()
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def loader_shard_kwargs(mesh: Optional[Mesh] = None) -> Dict[str, int]:
    """The row split of ``DataLoader`` and ``build_device_cache``
    (``num_hosts``, ``host_id``): one share a rank."""
    mesh = mesh or get_mesh()
    return dict(num_hosts=mesh.world, host_id=mesh.rank)


def train_loader(dataset, total_bs: int, seed: int, mesh: Optional[Mesh] = None):
    """A run's train loader: shuffled global batches of ``total_bs`` (a
    multiple of the world size), of which this rank loads its contiguous
    ``total_bs / world`` rows."""
    from ..data.loader import DataLoader

    mesh = mesh or get_mesh()
    if total_bs % mesh.world:
        raise ValueError(f"total_bs {total_bs} does not split over {mesh.world} ranks")
    return DataLoader(dataset, total_bs // mesh.world, shuffle=True, seed=seed,
                      **loader_shard_kwargs(mesh))


def pad_to_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad a short tail batch along axis 0 to ``batch_size``; callers
    slice the outputs back to the true count."""
    n = arr.shape[0]
    if n >= batch_size:
        return arr
    return np.concatenate([arr, np.zeros((batch_size - n,) + arr.shape[1:], arr.dtype)])


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a global batch of ``n`` (a multiple of
    the world size)."""
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} does not split over {mesh.world} ranks")
    b = n // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Optional[Mesh], batch, dim: int = 0, local: bool = False):
    """A batch (a tensor, an array, or a dict / list / tuple of them) for
    this rank. ``local=True``: each rank already holds its own rows (the
    train loaders), returned as they are. ``local=False``: every rank holds
    the global batch and takes its contiguous slice along ``dim``."""
    mesh = mesh or get_mesh()
    if local or mesh.world == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, dim) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, dim) for v in batch)
    rows = local_rows(mesh, batch.shape[dim])
    index = (slice(None),) * dim + (rows,)
    return batch[index]


@torch.no_grad()
def replicate(mesh: Optional[Mesh], module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so every
    rank starts from the same weights."""
    mesh = mesh or get_mesh()
    if mesh.group is not None and mesh.world > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


# -------------------------------------------------------------- collectives

def exact_sum_of_disjoint(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """All-reduce of a tensor to which each element has at most one rank
    with a non-zero value, bit for bit: the sum runs over its bytes as
    integers, where a sum with zeros cannot carry (-0.0 and NaN payloads
    kept). The counterpart of the JAX cache's ``psum_scatter``."""
    if mesh.world == 1:
        return t
    buf = t.contiguous().clone()
    dist.all_reduce(buf.view(torch.uint8), group=mesh.group)
    return buf


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, bit for bit, on every rank."""
    mesh = mesh or get_mesh()
    if mesh.world == 1:
        return x
    b = x.shape[0]
    out = x.new_zeros((b * mesh.world,) + tuple(x.shape[1:]))
    out[mesh.rank * b:(mesh.rank + 1) * b] = x
    return exact_sum_of_disjoint(mesh, out)


class _GlobalSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` summed over the ranks of a group of more than one (the
    identity otherwise), differentiable: each rank's backward receives the
    sum of every rank's gradient of the result."""
    mesh = mesh or get_mesh()
    if mesh.world == 1:
        return x
    return _GlobalSum.apply(x, mesh.group)


@torch.no_grad()
def mean_over_ranks(tensors: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None
                    ) -> Dict[str, torch.Tensor]:
    """A step's metrics averaged over ranks (one all-reduce), so each rank
    reports the global batch's values; the identity on one rank."""
    mesh = mesh or get_mesh()
    if mesh.world == 1 or not tensors:
        return tensors
    keys = list(tensors)
    flat = torch.stack([tensors[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    flat = flat / mesh.world
    return {k: flat[i].to(tensors[k].dtype) for i, k in enumerate(keys)}


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Replace each parameter's gradient by its mean over the group's ranks
    (a missing gradient counts as zeros): one flattened bucket per dtype,
    summed by one all-reduce and divided by the world size; each gradient
    becomes a view of its bucket (no copy back). Without a group,
    nothing."""
    if mesh.group is None:
        return
    buckets: Dict[torch.dtype, List[torch.nn.Parameter]] = {}
    for p in params:
        buckets.setdefault(p.dtype, []).append(p)
    for ps in buckets.values():
        flat = torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                          else p.grad.reshape(-1) for p in ps])
        dist.all_reduce(flat, group=mesh.group)
        if mesh.world > 1:
            flat.div_(mesh.world)
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p)
            off += n


# ------------------------------------------------------- draws and eval

def _batch_dims(a, b):
    """The batch axis of every tensor of two draws of one sampler, at batch
    B (``a``) and B + 1 (``b``): the one axis whose length differs, None
    for a tensor the batch shares."""
    if isinstance(a, torch.Tensor):
        dims = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if a.dim() != b.dim() or len(dims) > 1:
            raise ValueError(f"draw shapes {tuple(a.shape)} / {tuple(b.shape)} have no "
                             f"single batch axis")
        return dims[0] if dims else None
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return {f.name: _batch_dims(getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)}
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise ValueError("a list of draws whose length follows the batch")
        return [_batch_dims(x, y) for x, y in zip(a, b)]
    return None


def _take(x, plan, rows: slice):
    if isinstance(x, torch.Tensor):
        if plan is None:
            return x
        return x.narrow(plan, rows.start, rows.stop - rows.start).contiguous()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _take(getattr(x, f.name), plan[f.name], rows)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(_take(v, p, rows) for v, p in zip(x, plan))
    return x


def draw_rows(sample: Callable[[int, Optional[torch.Generator]], Any], local_batch: int,
              generator: Optional[torch.Generator], mesh: Optional[Mesh] = None,
              plans: Optional[dict] = None):
    """A step's draws for this rank's ``local_batch`` rows. On one rank,
    ``sample(local_batch, generator)``. In a group, the global batch's
    draws from ``generator`` (seeded alike on every rank), of which this
    rank keeps its rows: the batch axis of each tensor is found once, from
    two draws at batches B and B + 1 from throwaway generators, and kept in
    ``plans``."""
    mesh = mesh or get_mesh()
    if mesh.world == 1:
        return sample(local_batch, generator)
    if generator is None:
        raise ValueError("a step under a process group needs a generator seeded alike on "
                         "every rank (or its draws)")
    B = local_batch * mesh.world
    plans = {} if plans is None else plans
    if B not in plans:
        probe = [sample(b, torch.Generator(device=generator.device).manual_seed(0))
                 for b in (B, B + 1)]
        plans[B] = _batch_dims(*probe)
    return _take(sample(B, generator), plans[B], local_rows(mesh, B))


def row_drawer(sample: Callable[[int, int, Optional[torch.Generator]], Any]) -> Callable:
    """A step's drawer: ``draws(local_batch, n, generator)`` is
    ``draw_rows`` of ``sample(batch, n, generator)`` (every draw of one
    step for ``batch`` clouds of ``n`` points, in the step's own order),
    its batch axes found once a global batch. Every step takes its draws
    through one, so a run without a group draws as each rank of a group
    does."""
    plans: dict = {}

    def draws(local_batch: int, n: int, generator: Optional[torch.Generator]):
        return draw_rows(lambda b, g: sample(b, n, g), local_batch, generator, plans=plans)

    return draws


def sharded_eval(fn: Callable, *tensors: torch.Tensor, mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """``fn(*tensors)`` with the rows split over ranks: the tensors (equal
    first dimension n) are zero-padded to a multiple of the world size,
    each rank runs ``fn`` on its contiguous slice, and the output (rows
    first) is gathered and cut back to n. On one rank, ``fn(*tensors)``."""
    mesh = mesh or get_mesh()
    if mesh.world == 1:
        return fn(*tensors)
    n = tensors[0].shape[0]
    total = -(-n // mesh.world) * mesh.world
    rows = local_rows(mesh, total)
    out = fn(*[torch.cat([t, t.new_zeros((total - n,) + tuple(t.shape[1:]))])[rows]
               for t in tensors])
    return all_gather_rows(mesh, out.contiguous())[:n]


def prebuild(mesh: Optional[Mesh] = None) -> None:
    """Build the CUDA kernels and the native IO library on local rank 0
    first; the other ranks wait at a barrier and then find them built
    (a build is safe to race, but would run ``nvcc`` once a rank)."""
    mesh = mesh or get_mesh()
    if mesh.group is None or mesh.world == 1:
        return
    if mesh.local_rank == 0:
        from ..data import native_io

        if mesh.device is not None and mesh.device.type == "cuda":
            from ..utils import kernels

            kernels.build()
        native_io.library()
    barrier(mesh)
