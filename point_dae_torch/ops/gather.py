"""Row gather ``out[b, q] = x[b, idx[b, q]]`` with the small-C kernel.

Port of ``point_dae_tpu/ops/pallas_scatter.py:gather_rows`` and
``gather_rows_small_c_pallas``; the CUDA kernel is ``csrc/gather.cu``.
The backward is a plain scatter-add outside the gate of the JAX package's
one-hot scatter kernel (``scatter_rows_add_pallas``: C >= 32, N <= 2048);
that kernel is still to be ported, so inside its gate a CUDA tensor raises.
"""
from __future__ import annotations

import torch

from ..utils import kernels


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


def gather_rows_small_c_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x: (B, N, C), idx: (B, Q)."""
    C = x.shape[-1]
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, C))


def gather_rows_small_c(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The small-C gather kernel on a CUDA tensor, its plain version on a
    CPU one. x: (B, N, C <= 8) f32, idx: (B, Q) -> (B, Q, C) f32."""
    if x.device.type == "cpu":
        return gather_rows_small_c_plain(x, idx)
    B, N, C = x.shape
    if C > 8 or x.dtype != torch.float32:
        raise ValueError(f"small-C gather takes (B, N, C<=8) f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    kernels.require_cuda(x, idx32)
    Q = idx32.shape[1]
    out = torch.empty((B, Q, C), dtype=torch.float32, device=x.device)
    P, I = kernels.P, kernels.I
    kernels.launch("gather_rows_small_c", "gather", "gather_rows_small_c",
                   (P, P, P, I, I, I, I, P), x.data_ptr(), idx32.data_ptr(),
                   out.data_ptr(), B, N, Q, C, kernels.stream(x))
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        if use_small_c_kernel(x, idx.shape[1]):
            return gather_rows_small_c(x, idx)
        return gather_rows_small_c_plain(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, Q, C = g.shape
        if use_scatter_kernel(g.device.type, B, Q, ctx.n, C):
            raise NotImplementedError(
                f"backward of gather_rows on CUDA at ({B}, {ctx.n}, {C}) from "
                f"{Q} rows needs the one-hot scatter kernel "
                "(pallas_scatter.scatter_rows_add_pallas), which is not ported yet")
        gx = torch.zeros((B, ctx.n, C), dtype=g.dtype, device=g.device)
        gx.scatter_add_(1, idx.long()[..., None].expand(-1, -1, C), g)
        return gx, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, C), idx: (B, Q) int -> (B, Q, C) = x[b, idx[b, q]]."""
    return _GatherRows.apply(x, idx)
