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
processes with ``torchrun --nproc_per_node=N main_torch.py ...``.

Tensor parallelism (port of ``point_dae_tpu/parallel/mesh.py:112-178``):
``get_mesh_2d(model_parallel)`` lays the ranks out as JAX's
``devices.reshape(n / tp, tp)``: model groups are consecutive ranks
(``[0, 1], [2, 3]``), data groups strided (``[0, 2], [1, 3]``). A ``Mesh``'s
``world``, ``rank`` and ``group`` stay the *data* axis, so every
data-parallel helper above runs over the data group unchanged; the model
axis is ``model_world``, ``model_rank`` and ``model_group``.
``shard_params`` splits the ViT blocks (``models/layers.py:
TransformerBlock``) Megatron-style by the JAX rule (``param_spec``): ``qkv``
(by heads) and ``fc1`` by output features, ``proj`` and ``fc2`` by input
features; each row-split product is summed over the model group in f32
(``reduce_from_model``) before its bias and the residual. Where the JAX
package lets GSPMD insert the collectives, the port's blocks call
``copy_to_model``, ``reduce_from_model`` and ``gather_from_model``
themselves.
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group a process belongs to: ``world`` ranks on the data
    axis, this one ``rank`` (``local_rank`` on its host), its ``device`` and
    the data axis's ``group`` (None: no process group, one process). Under
    ``get_mesh_2d`` the model axis adds ``model_world`` ranks, this one
    ``model_rank``, over ``model_group``; the global rank is ``rank *
    model_world + model_rank``."""
    world: int = 1
    rank: int = 0
    local_rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None
    model_world: int = 1
    model_rank: int = 0
    model_group: Any = None

    @property
    def global_rank(self) -> int:
        return self.rank * self.model_world + self.model_rank

    @property
    def is_main(self) -> bool:
        return self.global_rank == 0


_device: Optional[torch.device] = None
_local_rank = 0
_mesh_2d: Optional[Mesh] = None


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
    """The current process group as a ``Mesh``: the 2-D one after
    ``get_mesh_2d``, else the whole world on the data axis; ``Mesh()``
    (world 1, no group) when none was formed."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    if _mesh_2d is not None:
        return _mesh_2d
    return Mesh(dist.get_world_size(), dist.get_rank(), _local_rank, _device,
                dist.group.WORLD)


def get_mesh_2d(model_parallel: int = 1, mesh: Optional[Mesh] = None) -> Mesh:
    """The ('data', 'model') layout of the process group (JAX
    ``get_mesh_2d``): the world's W ranks as ``reshape(W / tp, tp)``, rank g
    at data rank ``g // tp`` and model rank ``g % tp``. Every rank forms
    every data group and every model group, in the same order
    (``dist.new_group`` is collective over the world). From then on
    ``get_mesh()`` returns it. ``model_parallel`` 1 leaves the 1-D mesh as
    it is."""
    global _mesh_2d
    mesh = mesh or get_mesh()
    tp = int(model_parallel)
    if tp == 1:
        return mesh
    if mesh.group is None:
        raise ValueError(f"model_parallel {tp} needs a process group "
                         f"(initialize_distributed first)")
    if mesh.model_world != 1:
        raise ValueError("the mesh is 2-D already")
    world, rank = mesh.world, mesh.rank
    if world % tp:
        raise ValueError(f"{world} ranks do not split into model groups of {tp}")
    dp = world // tp
    data_groups = [dist.new_group([m + tp * i for i in range(dp)]) for m in range(tp)]
    model_groups = [dist.new_group(list(range(tp * i, tp * (i + 1)))) for i in range(dp)]
    # a data axis of one rank has no group: its helpers are the identity, as
    # on one process (no all-reduce of the gradients over a group of one)
    _mesh_2d = Mesh(dp, rank // tp, mesh.local_rank, mesh.device,
                    data_groups[rank % tp] if dp > 1 else None, tp, rank % tp,
                    model_groups[rank // tp])
    return _mesh_2d


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _mesh_2d
    _mesh_2d = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Wait for every rank of the world (both axes of a 2-D mesh)."""
    mesh = mesh or get_mesh()
    if mesh.group is not None or mesh.model_group is not None:
        dist.barrier()


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
    """Broadcast ``module``'s parameters and buffers from global rank 0, so
    every rank starts from the same weights. Under a 2-D mesh a whole
    tensor goes over the world and a shard (``shard_params``) over its data
    group, from the group's first rank (its global rank is this rank's
    model rank)."""
    mesh = mesh or get_mesh()
    if (mesh.group is None and mesh.model_group is None) or mesh.world * mesh.model_world == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        if getattr(t, "tp_dim", None) is not None:
            if mesh.world > 1:
                dist.broadcast(t.data, src=mesh.model_rank, group=mesh.group)
        elif mesh.model_world > 1:
            dist.broadcast(t.data, src=0)
        else:
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
    return _exact_sum(t, mesh.group)


def _exact_sum(t: torch.Tensor, group) -> torch.Tensor:
    buf = t.contiguous().clone()
    dist.all_reduce(buf.view(torch.uint8), group=group)
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
    if (mesh.group is None and mesh.model_group is None) or mesh.world * mesh.model_world == 1:
        return
    if mesh.local_rank == 0:
        from ..data import native_io

        if mesh.device is not None and mesh.device.type == "cuda":
            from ..utils import kernels

            kernels.build()
        native_io.library()
    barrier(mesh)


# ------------------------------------------------- tensor parallelism (TP)

# The JAX package's Megatron rule, keyed by flax path suffixes of the ViT
# blocks (``point_dae_tpu/parallel/mesh.py:128-132``): the first Dense of
# each pair splits its output features (column parallel), the second its
# input features (row parallel)
_COLUMN_SUFFIXES = ("attn/qkv/kernel", "mlp_fc1/kernel")
_ROW_SUFFIXES = ("attn/proj/kernel", "mlp_fc2/kernel")
_COLUMN_BIAS = ("attn/qkv/bias", "mlp_fc1/bias")
# a block's split tensors: (module, q/k/v chunks along the split dimension)
_BLOCK_SPLITS = (("attn.qkv", 3), ("attn.proj", 1), ("mlp.fc1", 1), ("mlp.fc2", 1))


def param_spec(path: str, ndim: int) -> Optional[int]:
    """The dimension of the *torch* tensor that the JAX ``param_spec``
    splits over the model axis for the flax leaf at ``path`` (None: kept
    whole). A flax ``kernel`` is ``(in, out)`` and a torch ``weight``
    ``(out, in)``: JAX's ``P(None, 'model')`` (output features) is the
    weight's dimension 0, ``P('model', None)`` (input features) its
    dimension 1."""
    if ndim == 2:
        if path.endswith(_COLUMN_SUFFIXES):
            return 0
        if path.endswith(_ROW_SUFFIXES):
            return 1
    if ndim == 1 and path.endswith(_COLUMN_BIAS):
        return 0
    return None


def _flax_leaf(name: str, ndim: int) -> str:
    leaf = name.rpartition(".")[2]
    if leaf == "weight":
        return "kernel" if ndim == 2 else "scale"
    return leaf


def shard_plan(model: torch.nn.Module, model_parallel: int) -> Dict[str, tuple]:
    """Which parameters ``shard_params`` splits at ``model_parallel`` ranks
    on the model axis: torch name -> (dimension, chunks), where the
    dimension comes from ``param_spec`` on the parameter's flax path
    (``utils/convert.py:flax_paths``) and ``chunks`` is 3 for ``qkv``,
    whose rows are q, k and v one after another: each chunk splits alike,
    so a rank holds the q, k and v rows of its heads. Only the parameters
    of the port's ``TransformerBlock`` split. As in JAX, a dimension that
    ``model_parallel`` does not divide stays whole; unlike JAX, a block
    whose head count it does not divide keeps its attention whole (JAX
    splits ``qkv`` by 3C all the same and GSPMD reshards it around the
    heads; the port splits by heads or not at all)."""
    from ..models.layers import TransformerBlock
    from ..utils.convert import flax_paths

    tp = int(model_parallel)
    blocks = [(pfx, m) for pfx, m in model.named_modules() if isinstance(m, TransformerBlock)]
    if tp == 1 or not blocks:
        return {}
    named = dict(model.named_parameters())
    paths = flax_paths(list(named))
    plan = {}
    for pfx, blk in blocks:
        for sub, chunks in _BLOCK_SPLITS:
            if sub.startswith("attn") and blk.attn.num_heads % tp:
                continue
            for leaf in ("weight", "bias"):
                name = f"{pfx}.{sub}.{leaf}" if pfx else f"{sub}.{leaf}"
                p = named.get(name)
                if p is None:
                    continue
                dim = param_spec(f"{paths[name]}/{_flax_leaf(name, p.dim())}", p.dim())
                if dim is not None and p.shape[dim] % (chunks * tp) == 0:
                    plan[name] = (dim, chunks)
    return plan


def _chunked(shape, dim: int, chunks: int):
    return tuple(shape[:dim]) + (chunks, shape[dim] // chunks) + tuple(shape[dim + 1:])


def split_shard(t: torch.Tensor, dim: int, chunks: int, parts: int, index: int
                ) -> torch.Tensor:
    """Shard ``index`` of ``parts`` of ``t`` along ``dim``: each of its
    ``chunks`` equal chunks along ``dim`` split into ``parts`` contiguous
    pieces, this shard's piece of every chunk in order."""
    n = t.shape[dim] // chunks // parts
    v = t.reshape(_chunked(t.shape, dim, chunks)).narrow(dim + 1, index * n, n)
    shape = list(t.shape)
    shape[dim] //= parts
    return v.reshape(shape).contiguous()


def _gather_shards(mesh: Mesh, shards: Sequence[torch.Tensor], specs: Sequence[tuple]
                   ) -> List[torch.Tensor]:
    """The whole tensors of ``shards`` (each with its (dim, chunks)) on
    every rank of the model group, bit for bit: each rank writes its shard
    into zeros and one exact all-reduce over the bytes of all of them sums
    them."""
    tp, r = mesh.model_world, mesh.model_rank
    flat, shapes = [], []
    for s, (dim, chunks) in zip(shards, specs):
        shape = list(s.shape)
        shape[dim] *= tp
        full = s.new_zeros(_chunked(shape, dim, chunks))
        n = s.shape[dim] // chunks
        full.narrow(dim + 1, r * n, n).copy_(s.reshape(_chunked(s.shape, dim, chunks)))
        flat.append(full.reshape(-1).view(torch.uint8))
        shapes.append((shape, s.dtype))
    summed = _exact_sum(torch.cat(flat), mesh.model_group)
    out, off = [], 0
    for shape, dt in shapes:
        nb = math.prod(shape) * torch.empty((), dtype=dt).element_size()
        out.append(summed[off:off + nb].view(dt).reshape(shape).clone())   # own, aligned
        off += nb
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the model
    group's gradients (each rank's column-split product gives a part) in
    f32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=ctx.group)     # in f32, rounded once
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the model group's sum forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The whole tensors of model-group shards; the backward keeps this
    rank's slice of each whole tensor's gradient. Every model rank runs the
    same computation on the whole tensors from the same inputs, so their
    gradients are equal and the slice is the shard's gradient (a
    reduce-scatter would count it model_world times)."""

    @staticmethod
    def forward(ctx, mesh, specs, *shards):
        ctx.mesh, ctx.specs = mesh, specs
        return tuple(_gather_shards(mesh, shards, specs))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        return (None, None) + tuple(
            None if g is None else split_shard(g, dim, chunks, mesh.model_world,
                                               mesh.model_rank)
            for g, (dim, chunks) in zip(grads, ctx.specs))


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as it is, whose gradient the model group sums (before a
    column-split product); the identity on one model rank."""
    if mesh.model_world == 1:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model group's sum of ``x`` (a row-split product's parts), whose
    gradient passes as it is; the identity on one model rank."""
    if mesh.model_world == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(mesh: Mesh, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The whole tensors of ``params`` (one all-reduce for all): a shard
    (``tp_dim`` set by ``shard_params``) gathered, differentiably, a whole
    parameter as it is."""
    idx = [i for i, p in enumerate(params) if getattr(p, "tp_dim", None) is not None]
    out = list(params)
    if mesh.model_world == 1 or not idx:
        return out
    specs = tuple((params[i].tp_dim, params[i].tp_chunks) for i in idx)
    whole = _GatherFromModel.apply(mesh, specs, *[params[i] for i in idx])
    for i, w in zip(idx, whole):
        out[i] = w
    return out


@torch.no_grad()
def shard_params(mesh: Optional[Mesh], model: torch.nn.Module) -> torch.nn.Module:
    """Split ``model``'s ViT blocks over the model axis (JAX
    ``shard_params``), in place: each parameter of ``shard_plan`` becomes
    this rank's shard (a new ``nn.Parameter`` carrying ``tp_dim`` and
    ``tp_chunks``), and each block, and its attention where the heads
    split, keeps the mesh (``tp``) to run its products on shards. Build the
    optimizer *after* this, as the JAX docstring says: AdamW's moments then
    live on shards (AdamW is elementwise). A mesh with one model rank
    leaves the model as it is. Returns the model."""
    from ..models.layers import TransformerBlock

    mesh = mesh or get_mesh()
    if mesh.model_world == 1:
        return model
    if getattr(model, "tp_mesh", None) is not None:
        raise ValueError("the model is sharded already")
    plan = shard_plan(model, mesh.model_world)
    for name, (dim, chunks) in plan.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        p = getattr(mod, leaf)
        shard = torch.nn.Parameter(split_shard(p.data, dim, chunks, mesh.model_world,
                                               mesh.model_rank), requires_grad=p.requires_grad)
        shard.tp_dim, shard.tp_chunks = dim, chunks
        setattr(mod, leaf, shard)
    for pfx, blk in model.named_modules():
        if not isinstance(blk, TransformerBlock):
            continue
        split = {sub: f"{pfx}.{sub}.weight".lstrip(".") in plan for sub, _ in _BLOCK_SPLITS}
        if split["attn.qkv"] != split["attn.proj"] or split["mlp.fc1"] != split["mlp.fc2"]:
            raise ValueError(f"block {pfx!r}: a column split without its row split: {split}")
        blk.tp = mesh if split["mlp.fc1"] else None
        blk.attn.tp = mesh if split["attn.qkv"] else None
    model.tp_mesh = mesh
    return model


def _whole_tensors(mesh: Mesh, named: Dict[str, torch.Tensor],
                   specs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """``named`` with each tensor of ``specs`` gathered (one all-reduce)."""
    keys = [k for k in named if k in specs]
    out = dict(named)
    if keys:
        for k, w in zip(keys, _gather_shards(mesh, [named[k].detach() for k in keys],
                                             [specs[k] for k in keys])):
            out[k] = w
    return out


def _specs(model: torch.nn.Module) -> Dict[str, tuple]:
    return {n: (p.tp_dim, p.tp_chunks) for n, p in model.named_parameters()
            if getattr(p, "tp_dim", None) is not None}


@torch.no_grad()
def gather_params(mesh: Optional[Mesh], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every shard gathered whole (collective
    over the model group): the one-process layout, which ``to_flax`` and a
    one-process model take. Without shards, the state dict itself."""
    mesh = mesh or get_mesh()
    sd = model.state_dict()
    specs = _specs(model)
    if not specs:
        return sd
    return _whole_tensors(mesh, sd, specs)


def _map_moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer, sd: dict,
                 fn: Callable[[tuple, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]) -> dict:
    """``sd`` (an ``optimizer.state_dict()`` of ``optimizer``) with each
    shard's moments (its tensors of dim > 0) replaced by ``fn(spec,
    moments)``, the parameters taken in index order on every rank."""
    specs = _specs(model)
    if not specs:
        return sd
    ps = [p for g in optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in model.named_parameters()}
    state = {}
    for pid in sorted(sd["state"], key=int):
        entry = dict(sd["state"][pid])
        spec = specs.get(names.get(id(ps[int(pid)])))
        if spec is not None:
            entry.update(fn(spec, {k: v for k, v in entry.items()
                                   if isinstance(v, torch.Tensor) and v.dim() > 0}))
        state[pid] = entry
    return dict(sd, state=state)


@torch.no_grad()
def gather_optimizer_state(mesh: Optional[Mesh], model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with each moment of a shard gathered whole
    (collective over the model group), in the one-process layout."""
    mesh = mesh or get_mesh()
    return _map_moments(model, optimizer, optimizer.state_dict(),
                        lambda spec, moments: _whole_tensors(
                            mesh, moments, {k: spec for k in moments}))


@torch.no_grad()
def shard_state(mesh: Optional[Mesh], model: torch.nn.Module, state_dict: Dict
                ) -> Dict[str, torch.Tensor]:
    """A one-process state dict cut to ``model``'s shards (for
    ``load_state_dict`` on a sharded model)."""
    mesh = mesh or get_mesh()
    specs = _specs(model)
    return {k: split_shard(v, *specs[k], mesh.model_world, mesh.model_rank)
            if k in specs else v for k, v in state_dict.items()}


@torch.no_grad()
def shard_optimizer_state(mesh: Optional[Mesh], model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, sd: dict) -> dict:
    """A one-process ``optimizer.state_dict()`` cut to ``model``'s shards
    (for ``optimizer.load_state_dict`` after ``shard_params``)."""
    mesh = mesh or get_mesh()
    return _map_moments(model, optimizer, sd, lambda spec, moments: {
        k: split_shard(v, *spec, mesh.model_world, mesh.model_rank)
        for k, v in moments.items()})
