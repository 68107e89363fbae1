"""Row gather ``out[b, q] = x[b, idx[b, q]]`` and its backward, the row
scatter-add, each with its kernel.

Port of ``point_dae_tpu/ops/pallas_scatter.py:gather_rows``,
``gather_rows_small_c_pallas`` (CUDA kernel ``csrc/gather.cu``),
``gather_rows_pallas`` (``gather_rows_wide``, the third entry of
``csrc/gather.cu``; nothing dispatches it, as nothing dispatches the JAX
one: both packages keep the library gather forward),
``scatter_rows_add_pallas`` (CUDA kernel ``csrc/scatter.cu``) and the
rank-keyed select ``gather_by_key_small_c_pallas`` (the second entry of
``csrc/gather.cu``: ``gather_by_key`` from given keys, ``gather_by_mask``
from a mask, which the masked resample uses). Inside the
JAX gate of the scatter (C >= 32, N <= 2048, B*Q*C >= 2^24) the backward of
``gather_rows`` on a CUDA tensor launches the scatter kernel; elsewhere it
is a plain ``scatter_add_`` in g's type.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import kernels

MAX_ROWS = 2048     # csrc/scatter.cu: 16 warps' row histograms in a block's shared memory
MAX_SEGS = 16       # csrc/scatter.cu kMaxSegs: segments a cloud of the counting sort
MIN_SEG = 512       # entries a segment keeps at least
H100_SMS = 132


def use_small_c_kernel(x: torch.Tensor, q: int) -> bool:
    """``pallas_scatter._use_mxu_small_c_gather`` with "on TPU" read as "on
    CUDA"."""
    B, N, C = x.shape
    return (x.device.type == "cuda" and C <= 8 and N <= 2048
            and N % min(N, 2048) == 0 and x.dtype == torch.float32
            and B * q >= 2 ** 18)


def use_scatter_kernel(device_type: str, B: int, Q: int, N: int, C: int) -> bool:
    """``pallas_scatter._use_mxu_scatter`` with "on TPU" read as "on CUDA"."""
    return device_type == "cuda" and N <= 2048 and C >= 32 and B * Q * C >= 2 ** 24


def scatter_rows_add_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel: idx (B, Q), g (B, Q, C)
    -> (B, n_rows, C) f32, ``out[b, m] = sum of g[b, q] over idx[b, q] == m``;
    entries outside [0, n_rows) add nothing (they go to a spare row). On the
    CPU, ``scatter_add_`` adds each element's contributors in ascending q,
    which is the kernel's order, so the two agree bit for bit."""
    B, Q, C = g.shape
    idx = idx.long()
    key = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = torch.zeros((B, n_rows + 1, C), dtype=torch.float32, device=g.device)
    out.scatter_add_(1, key[..., None].expand(-1, -1, C), g.float())
    return out[:, :n_rows].contiguous()


class ScatterPlan(NamedTuple):
    """How ``csrc/scatter.cu`` launches: ``segs`` segments a cloud for the
    counting sort (a block each), then the sums with ``vec`` elements a lane
    and ``lanes`` lanes a row (32 / lanes rows a warp)."""
    segs: int
    vec: int
    lanes: int


def scatter_plan(B: int, Q: int, C: int, elem_bytes: int, aligned_bytes: int,
                 sms: int = H100_SMS) -> ScatterPlan:
    """The sort: segments of at least ``MIN_SEG`` entries, about one block an
    SM over the B clouds, at most ``MAX_SEGS`` (each segment's place pass
    reads the cloud's counts and walks all N rows, so more segments cost
    more than they spread). The sums: the widest load (16 bytes down to one
    element) that divides C and the alignment of g (``aligned_bytes``, a
    power of two), then the fewest lanes (a power of two, at most 32) whose
    loads cover C."""
    segs = max(1, min(MAX_SEGS, round(sms / max(B, 1)), Q // MIN_SEG))
    vec = next(v for v in (16 // elem_bytes, 4, 2, 1)
               if v <= 8 and C % v == 0 and aligned_bytes % (v * elem_bytes) == 0)
    lanes = 1
    while lanes < 32 and lanes * vec < C:
        lanes *= 2
    return ScatterPlan(segs, vec, lanes)


def scatter_work_ints(B: int, Q: int, N: int, segs: int) -> int:
    """Ints of the kernel's scratch: the segments' counts (B, segs, N), the
    list starts (B, N + 1) and the lists (B, Q)."""
    return B * (segs * N + N + 1 + Q)


def scatter_lists_plain(idx: torch.Tensor, n_rows: int, segs: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The counting sort's scratch as the kernel leaves it, idx (B, Q) ->
    (counts (B, segs, N): the entries of segment s in row m; start (B, N + 1):
    where each row's list begins; order (B, Q): the lists one after another,
    each in ascending q, then -1 where the kernel leaves its scratch
    unwritten (as many as the entries outside [0, N))), all int32. Segment s
    holds q in [s seg, (s + 1) seg), seg = ceil(Q / segs)."""
    B, Q = idx.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < n_rows)
    key = torch.where(valid, idx, torch.full_like(idx, n_rows))
    seg = -(-Q // segs)
    onehot = torch.zeros((B, segs, n_rows + 1), dtype=torch.long, device=idx.device)
    onehot.index_put_((torch.arange(B, device=idx.device)[:, None].expand(B, Q),
                       torch.arange(Q, device=idx.device)[None, :].expand(B, Q) // seg, key),
                      torch.ones_like(key), accumulate=True)
    counts = onehot[:, :, :n_rows]
    start = torch.zeros((B, n_rows + 1), dtype=torch.long, device=idx.device)
    start[:, 1:] = torch.cumsum(counts.sum(1), 1)
    order = torch.argsort(key, dim=1, stable=True)
    order = torch.where(torch.arange(Q, device=idx.device) < start[:, n_rows:], order, -1)
    return counts.int(), start.int(), order.int()


def scatter_rows_add(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                     use_plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """The scatter kernel on a CUDA tensor, its plain version on a CPU one.
    idx (B, Q) int in [0, n_rows), g (B, Q, C) f32 or bf16 -> (B, n_rows, C)
    f32, each element the sum of its contributors in ascending q. Built for
    n_rows <= ``MAX_ROWS``; launched under ``scatter_plan`` (or
    ``use_plan``)."""
    if g.device.type == "cpu":
        return scatter_rows_add_plain(idx, g, n_rows)
    B, Q, C = g.shape
    if not 1 <= n_rows <= MAX_ROWS or g.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"scatter kernel is built for 1 <= N <= {MAX_ROWS} rows of "
                                  f"f32 or bf16, got {n_rows} of {g.dtype}")
    g = g.contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    kernels.require_cuda(g, idx32)
    if tuple(idx32.shape) != (B, Q):
        raise ValueError(f"idx {tuple(idx32.shape)} does not match g {tuple(g.shape)}")
    plan = use_plan or scatter_plan(B, Q, C, g.element_size(), g.data_ptr() & -g.data_ptr(),
                                    kernels.card_sms(g.device))
    work = torch.empty((scatter_work_ints(B, Q, n_rows, plan.segs),), dtype=torch.int32,
                       device=g.device)
    out = torch.empty((B, n_rows, C), dtype=torch.float32, device=g.device)
    P, I = kernels.P, kernels.I
    kernels.launch("scatter_rows_add", "scatter", "scatter_rows_add",
                   (P, I, P) + (I,) * 7 + (P, P, P), g.data_ptr(),
                   int(g.dtype == torch.bfloat16), idx32.data_ptr(), B, Q, n_rows, C, *plan,
                   work.data_ptr(), out.data_ptr(), kernels.stream(g))
    return out


def scatter_lists_kernel(idx: torch.Tensor, n_rows: int, segs: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scatter kernel's counting sort alone (the library's
    ``scatter_lists`` check entry, off every model path and not counted):
    (counts, start, order) as ``scatter_lists_plain`` gives them."""
    idx32 = idx.to(torch.int32).contiguous()
    kernels.require_cuda(idx32)
    B, Q = idx32.shape
    work = torch.empty((scatter_work_ints(B, Q, n_rows, segs),), dtype=torch.int32,
                       device=idx.device)
    fn = kernels.library("scatter").scatter_lists
    fn.argtypes = [kernels.P] + [kernels.I] * 4 + [kernels.P, kernels.P]
    err = fn(idx32.data_ptr(), B, Q, n_rows, segs, work.data_ptr(), kernels.stream(idx32))
    if err != 0:
        raise RuntimeError(f"CUDA kernel scatter_lists failed to launch ({err})")
    o = B * segs * n_rows
    e = o + B * (n_rows + 1)
    return work[:o].view(B, segs, n_rows), work[o:e].view(B, n_rows + 1), work[e:].view(B, Q)


def gather_rows_small_c_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x: (B, N, C), idx: (B, Q)."""
    C = x.shape[-1]
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, C))


_INDEX_TYPES = (torch.int32, torch.int64)
_SMALL_C_ARGS = (kernels.P, kernels.P, kernels.I, kernels.P, kernels.I, kernels.I,
                 kernels.I, kernels.I, kernels.P)


def gather_rows_small_c(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The small-C gather kernel on a CUDA tensor, its plain version on a
    CPU one. x: (B, N, C <= 8) f32, idx: (B, Q) int32 or int64 (other
    integer types are widened) -> (B, Q, C) f32, zeros where an index falls
    outside [0, N). The usual call (both contiguous on one card) costs one
    test, one allocation and the ctypes call."""
    if x.device.type == "cpu":
        return gather_rows_small_c_plain(x, idx)
    if not (x.is_cuda and x.dtype == torch.float32 and x.shape[-1] <= 8
            and idx.dtype in _INDEX_TYPES and x.is_contiguous() and idx.is_contiguous()
            and idx.device == x.device and idx.dim() == 2 and idx.shape[0] == x.shape[0]):
        if x.shape[-1] > 8 or x.dtype != torch.float32:
            raise ValueError(f"small-C gather takes (B, N, C<=8) f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if idx.dim() != 2 or idx.shape[0] != x.shape[0]:
            raise ValueError(f"idx {tuple(idx.shape)} is not (B, Q) for x {tuple(x.shape)}")
        x = x.contiguous()
        idx = (idx if idx.dtype in _INDEX_TYPES else idx.long()).contiguous()
        kernels.require_cuda(x, idx)
    B, N, C = x.shape
    Q = idx.shape[1]
    out = torch.empty((B, Q, C), dtype=torch.float32, device=x.device)
    kernels.launch("gather_rows_small_c", "gather", "gather_rows_small_c", _SMALL_C_ARGS,
                   x.data_ptr(), idx.data_ptr(), idx.dtype == torch.int64, out.data_ptr(),
                   B, N, Q, C, kernels.stream(x))
    return out


def gather_rows_wide_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the wide kernel: x (B, N, C) any float type,
    idx (B, Q) -> (B, Q, C) f32, zeros where an index falls outside [0, N)
    (the one-hot product of ``gather_rows_pallas`` gives them)."""
    N, C = x.shape[1:]
    idx = idx.long()
    got = torch.gather(x.float(), 1, idx.clamp(0, N - 1)[..., None].expand(-1, -1, C))
    valid = ((idx >= 0) & (idx < N))[..., None]
    return torch.where(valid, got, torch.zeros((), device=x.device))


_WIDE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WIDE_ARGS = (kernels.P, kernels.I, kernels.P, kernels.I, kernels.P, kernels.I, kernels.I,
              kernels.I, kernels.I, kernels.I, kernels.P)


def gather_rows_wide(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The wide gather kernel on a CUDA tensor, its plain version on a CPU
    one: x (B, N, C) f32, bf16 or f16, idx (B, Q) int32 or int64 (read as
    given, no cast launch; other integer types are widened) -> (B, Q, C)
    f32, exact. No gradient flows through it."""
    if x.device.type == "cpu":
        return gather_rows_wide_plain(x, idx)
    B, N, C = x.shape
    if x.dtype not in _WIDE_DTYPES:
        raise ValueError(f"wide gather takes f32, bf16 or f16 rows, got {x.dtype}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("the wide gather has no backward")
    if idx.dim() != 2 or idx.shape[0] != B:
        raise ValueError(f"idx {tuple(idx.shape)} is not (B, Q) for x {tuple(x.shape)}")
    x = x.contiguous()
    idx = (idx if idx.dtype in _INDEX_TYPES else idx.long()).contiguous()
    kernels.require_cuda(x, idx)
    Q = idx.shape[1]
    out = torch.empty((B, Q, C), dtype=torch.float32, device=x.device)
    vec = C % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    kernels.launch("gather_rows_wide", "gather", "gather_rows_wide", _WIDE_ARGS,
                   x.data_ptr(), _WIDE_DTYPES[x.dtype], idx.data_ptr(),
                   idx.dtype == torch.int64, out.data_ptr(), B, N, Q, C, int(vec),
                   kernels.stream(x))
    return out


def _gather_rows_fwd(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if use_small_c_kernel(x, idx.shape[1]):
        return gather_rows_small_c(x, idx)
    return gather_rows_small_c_plain(x, idx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        return _gather_rows_fwd(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, Q, C = g.shape
        if use_scatter_kernel(g.device.type, B, Q, ctx.n, C):
            return scatter_rows_add(idx, g, ctx.n).to(g.dtype), None
        gx = torch.zeros((B, ctx.n, C), dtype=g.dtype, device=g.device)
        gx.scatter_add_(1, idx.long()[..., None].expand(-1, -1, C), g)
        return gx, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, C), idx: (B, Q) int -> (B, Q, C) = x[b, idx[b, q]]. Where x
    carries no gradient (the point clouds that ``group_points`` and the
    resample gather) the autograd function is skipped."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, idx)
    return _gather_rows_fwd(x, idx)


def gather_by_key_plain(x: torch.Tensor, keys: torch.Tensor, draw: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of the key gather: x (B, N, C), keys (B, N)
    (distinct ranks, -1 for rows no draw picks), draw (B, Q) >= 0 ->
    (B, Q, C) f32, ``out[b, q] = x[b, n]`` where ``keys[b, n] == draw[b, q]``,
    zeros where no key matches."""
    B, N, C = x.shape
    keys = keys.long()
    inv = torch.full((B, N + 1), -1, dtype=torch.long, device=x.device)
    slot = torch.where(keys >= 0, keys, N)                  # -1 keys land in slot N
    inv.scatter_(1, slot, torch.arange(N, device=x.device).expand(B, -1))
    inv[:, N] = -1
    d = draw.long()
    n = torch.where((d >= 0) & (d < N), inv.gather(1, d.clamp(0, N)), -1)
    got = torch.gather(x.float(), 1, n.clamp_min(0)[..., None].expand(-1, -1, C))
    return torch.where(n[..., None] >= 0, got, torch.zeros((), device=x.device))


def ranks_from_uniforms(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Uniforms u (B, Q) in [0, 1) -> int64 ranks floor(u * cnt) below each
    row's valid count cnt of mask (B, N) (at least 1); the f32-by-int64
    product multiplies in f32. The key gather kernel rounds the same way."""
    cnt = mask.sum(1).clamp_min(1)[:, None]
    return (u * cnt).long().clamp_max(cnt - 1)


def gather_by_mask_plain(x: torch.Tensor, mask: torch.Tensor, draws: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of the key gather from a mask: x (B, N, C), mask
    (B, N) bool, draws (B, Q) ranks or f32 uniforms (``ranks_from_uniforms``)
    -> (B, Q, C) f32: the point of rank draw among the row's valid points,
    zeros where the rank is not below the row's valid count. The keys are
    those of ``point_dae_tpu/ops/geometry.py:329-330``."""
    if draws.is_floating_point():
        draws = ranks_from_uniforms(mask, draws)
    rank = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keys = torch.where(mask, rank, -1)
    return gather_by_key_plain(x, keys, draws)


KEY_MAX_N = 12288       # csrc/gather.cu kKeyMaxN: the keys' table in 48 KB of shared memory
_KEY_TYPES = {torch.bool: 0, torch.int32: 1, torch.int64: 2}
_DRAW_TYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}
_KEY_ARGS = (kernels.P, kernels.P, kernels.I, kernels.P, kernels.I, kernels.P) + \
    (kernels.I,) * 5 + (kernels.P,)


def key_gather_threads(Q: int) -> int:
    """Threads of a key-gather block, one block a cloud: a thread a draw,
    the draws rounded up to a warp, 128 to 1024 (more draws take several
    passes)."""
    return min(1024, max(128, -(-Q // 32) * 32))


def _key_gather(x: torch.Tensor, keys: torch.Tensor, draw: torch.Tensor,
                threads: Optional[int]) -> torch.Tensor:
    """Check the shapes of either form, then launch the kernel."""
    B, N, C = x.shape
    if C > 8 or x.dtype != torch.float32 or N > KEY_MAX_N:
        raise ValueError(f"key gather takes (B, N <= {KEY_MAX_N}, C <= 8) f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("the key gather has no backward")
    if tuple(keys.shape) != (B, N) or draw.dim() != 2 or draw.shape[0] != B:
        raise ValueError(f"keys {tuple(keys.shape)} and draws {tuple(draw.shape)} do not "
                         f"match x {tuple(x.shape)}")
    x, keys, draw = x.contiguous(), keys.contiguous(), draw.contiguous()
    kernels.require_cuda(x, keys, draw)
    Q = draw.shape[1]
    out = torch.empty((B, Q, C), dtype=torch.float32, device=x.device)
    kernels.launch("key_gather", "gather", "gather_by_key_small_c", _KEY_ARGS, x.data_ptr(),
                   keys.data_ptr(), _KEY_TYPES[keys.dtype], draw.data_ptr(),
                   _DRAW_TYPES[draw.dtype], out.data_ptr(), B, N, Q, C,
                   threads or key_gather_threads(Q), kernels.stream(x))
    return out


def gather_by_key(x: torch.Tensor, keys: torch.Tensor, draw: torch.Tensor,
                  threads: Optional[int] = None) -> torch.Tensor:
    """The key gather kernel from given keys on a CUDA tensor, its plain
    version on a CPU one: x (B, N <= 12288, C <= 8) f32, keys (B, N) and
    draw (B, Q) int32 or int64, read as given (other integer types are
    widened) -> (B, Q, C) f32; ``threads`` a block (``key_gather_threads``
    when None). No gradient flows through it."""
    if x.device.type == "cpu":
        return gather_by_key_plain(x, keys, draw)
    if keys.dtype == torch.bool or keys.is_floating_point() or draw.is_floating_point():
        raise ValueError(f"gather_by_key takes integer keys and draws, got {keys.dtype} and "
                         f"{draw.dtype} (gather_by_mask takes a mask)")
    keys = keys if keys.dtype in _INDEX_TYPES else keys.long()
    draw = draw if draw.dtype in _INDEX_TYPES else draw.long()
    return _key_gather(x, keys, draw, threads)


def gather_by_mask(x: torch.Tensor, mask: torch.Tensor, draws: torch.Tensor,
                   threads: Optional[int] = None) -> torch.Tensor:
    """The key gather kernel from a mask on a CUDA tensor (one launch: the
    ranks, the uniforms' conversion and the copy), ``gather_by_mask_plain``
    on a CPU one: x (B, N <= 12288, C <= 8) f32, mask (B, N) bool, draws (B,
    Q) int32 or int64 ranks or f32 uniforms, read as given -> (B, Q, C)
    f32; ``threads`` a block (``key_gather_threads`` when None). No
    gradient flows through it."""
    if x.device.type == "cpu":
        return gather_by_mask_plain(x, mask, draws)
    if draws.is_floating_point() and draws.dtype != torch.float32:
        raise ValueError(f"uniform draws must be f32, got {draws.dtype}")
    mask = mask if mask.dtype == torch.bool else mask != 0
    draws = draws if draws.dtype in _DRAW_TYPES else draws.long()
    return _key_gather(x, mask, draws, threads)
