"""Row gather ``out[b, q] = x[b, idx[b, q]]`` and its backward, the row
scatter-add, each with its kernel.

Port of ``point_dae_tpu/ops/pallas_scatter.py:gather_rows``,
``gather_rows_small_c_pallas`` (CUDA kernel ``csrc/gather.cu``),
``gather_rows_pallas`` (``gather_rows_wide``, the third entry of
``csrc/gather.cu``; nothing dispatches it, as nothing dispatches the JAX
one: both packages keep the library gather forward),
``scatter_rows_add_pallas`` (CUDA kernel ``csrc/scatter.cu``) and the
rank-keyed select ``gather_by_key_small_c_pallas`` (the second entry of
``csrc/gather.cu``), which the masked resample uses. Inside the
JAX gate of the scatter (C >= 32, N <= 2048, B*Q*C >= 2^24) the backward of
``gather_rows`` on a CUDA tensor launches the scatter kernel; elsewhere it
is a plain ``scatter_add_`` in g's type.
"""
from __future__ import annotations

import torch

from ..utils import kernels

MAX_ROWS = 2048     # csrc/scatter.cu: 16 warps' row histograms in shared memory


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
    -> (B, n_rows, C) f32, ``out[b, m] = sum of g[b, q] over idx[b, q] == m``.
    On the CPU, ``scatter_add_`` adds each element's contributors in
    ascending q, which is the kernel's order, so the two agree bit for bit."""
    B, Q, C = g.shape
    out = torch.zeros((B, n_rows, C), dtype=torch.float32, device=g.device)
    return out.scatter_add_(1, idx.long()[..., None].expand(-1, -1, C), g.float())


def _vec_width(g: torch.Tensor) -> int:
    """Elements a lane loads at once: the largest of 4, 2, 1 that divides C,
    fits C in one warp's slice and keeps every row's loads aligned."""
    C = g.shape[-1]
    for v in (4, 2):
        if C % v == 0 and 32 * v <= C and g.data_ptr() % (v * g.element_size()) == 0:
            return v
    return 1


def scatter_rows_add(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The scatter kernel on a CUDA tensor, its plain version on a CPU one.
    idx (B, Q) int in [0, n_rows), g (B, Q, C) f32 or bf16 -> (B, n_rows, C)
    f32, each element the sum of its contributors in ascending q. Built for
    n_rows <= ``MAX_ROWS``."""
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
    row_ptr = torch.empty((B, n_rows + 1), dtype=torch.int32, device=g.device)
    order = torch.empty((B, Q), dtype=torch.int32, device=g.device)
    out = torch.empty((B, n_rows, C), dtype=torch.float32, device=g.device)
    P, I = kernels.P, kernels.I
    kernels.launch("scatter_rows_add", "scatter", "scatter_rows_add",
                   (P, I, P, I, I, I, I, I, P, P, P, P), g.data_ptr(),
                   int(g.dtype == torch.bfloat16), idx32.data_ptr(), B, Q, n_rows, C,
                   _vec_width(g), row_ptr.data_ptr(), order.data_ptr(), out.data_ptr(),
                   kernels.stream(g))
    return out


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


def gather_by_key(x: torch.Tensor, keys: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """The key gather kernel on a CUDA tensor, its plain version on a CPU
    one. x (B, N, C <= 8) f32, keys (B, N), draw (B, Q) -> (B, Q, C) f32.
    No gradient flows through it."""
    if x.device.type == "cpu":
        return gather_by_key_plain(x, keys, draw)
    B, N, C = x.shape
    if C > 8 or x.dtype != torch.float32 or N > 12288:
        raise ValueError(f"key gather takes (B, N <= 12288, C <= 8) f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("the key gather has no backward")
    x = x.contiguous()
    keys32 = keys.to(torch.int32).contiguous()
    draw32 = draw.to(torch.int32).contiguous()
    kernels.require_cuda(x, keys32, draw32)
    Q = draw32.shape[1]
    out = torch.empty((B, Q, C), dtype=torch.float32, device=x.device)
    P, I = kernels.P, kernels.I
    kernels.launch("key_gather", "gather", "gather_by_key_small_c",
                   (P, P, P, P, I, I, I, I, P), x.data_ptr(), keys32.data_ptr(),
                   draw32.data_ptr(), out.data_ptr(), B, N, Q, C, kernels.stream(x))
    return out
