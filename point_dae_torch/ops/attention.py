"""Fused self-attention at short sequence length: kernel wrappers, autograd
functions and plain version.

Port of ``point_dae_tpu/ops/pallas_attn.py:fused_attention``; the CUDA
kernels are ``csrc/attention.cu``: a warp owns 16 query rows of one
(cloud, head) and keeps their scores in registers (``mma.sync``), so the
result depends on no tile size. The TPU kernel's ``bc`` (clouds per
block-diagonal tile) exists to fill that chip's matrix unit; it survives
here only in the gate, which is the JAX gate in full (``pick_bc`` and the
tile terms included), so the port takes the kernel at exactly the shapes
the JAX package does, and the kernels take every shape inside it
(``kernel_takes``). The wrapper's transposes to ``(H, B*T, d)`` have no
counterpart: the kernels read ``(B, T, H, d)`` views by their strides.

Numerics of both versions: scores from bf16 q and k with f32 accumulation,
times ``d ** -0.5``; an invalid key *replaces* its score by -1e9; f32
softmax with row-max subtraction; the probabilities rounded to bf16 for the
product with v, accumulated in f32. The backward recomputes the scores,
rounds the cotangent and ``ds * scale`` to bf16 before their products, uses
the f32 probabilities in the softmax gradient and returns dq, dk, dv in
bf16. A cloud whose keys are all invalid attends uniformly over its own T
keys (the TPU tile spreads such a row over the whole tile; the models never
produce one).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import kernels

_BF = torch.bfloat16


def pick_bc(B: int, T: int, target_rows: int = 512) -> int:
    """``pallas_attn.pick_bc``: the largest clouds-per-tile bc with
    R = bc*T <= target_rows and B % bc == 0."""
    for bc in (16, 8, 4, 2, 1):
        if bc * T <= target_rows and B % bc == 0:
            return bc
    return 1


def supported(B: int, T: int, H: int, d: int, bc: Optional[int] = None) -> bool:
    """``pallas_attn.supported`` (with ``bc = pick_bc(B, T)`` unless given):
    the shapes the fused attention is taken for. ``kernel_takes`` holds on
    every shape inside it."""
    bc = pick_bc(B, T) if bc is None else bc
    R = bc * T
    return (B % bc == 0 and R % 8 == 0 and R <= 1024
            and d % 8 == 0 and d <= 256 and T >= 2)


def kernel_takes(B: int, T: int, H: int, d: int) -> bool:
    """The shapes the kernels are built for: any T >= 1 (T <= 64 in one key
    tile, longer rows in 64-key tiles) and d % 8 == 0 up to 256 (padded with
    zeros to 32, 64, 128 or 256)."""
    return B >= 0 and H >= 0 and T >= 1 and d % 8 == 0 and 0 <= d <= 256


def _probs(qb, kb, key_mask, scale):
    """(B, H, T, T) f32 softmax of the masked scaled scores."""
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s,
                        torch.full((), -1e9, dtype=s.dtype, device=s.device))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


class _AttnCorePlain(torch.autograd.Function):
    """Plain PyTorch version of the forward and backward kernels.
    q, k, v (B, T, H, d) bf16 -> (B, T, H, d) f32; dq, dk, dv in bf16."""

    @staticmethod
    def forward(ctx, qb, kb, vb, key_mask):
        ctx.save_for_backward(qb, kb, vb)
        ctx.key_mask = key_mask
        p = _probs(qb, kb, key_mask, qb.shape[-1] ** -0.5)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(_BF).float(), vb.float())

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb = ctx.saved_tensors
        scale = qb.shape[-1] ** -0.5
        p = _probs(qb, kb, ctx.key_mask, scale)
        pb = p.to(_BF).float()
        gb = g.float().to(_BF).float()
        dv = torch.einsum("bhqk,bqhd->bkhd", pb, gb)
        dp = torch.einsum("bqhd,bkhd->bhqk", gb, vb.float())
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dsb = (ds * scale).to(_BF).float()
        dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kb.float())
        dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qb.float())
        return dq.to(_BF), dk.to(_BF), dv.to(_BF), None


_P, _I, _F = kernels.P, kernels.I, kernels.F
_FWD_ARGS = (_P,) * 5 + (_I,) * 7 + (_F, _P)
_BWD_ARGS = (_P,) * 9 + (_I,) * 7 + (_F, _P)
_SHORT_T = 64   # csrc/attention.cu: longer rows take the two-launch backward


def _strided(qb, kb, vb):
    """q, k, v as tensors the kernels can read in place: unit stride along
    d and one set of (cloud, token, head) strides for all three."""
    if not (qb.stride() == kb.stride() == vb.stride() and qb.stride(3) == 1
            and all(s % 8 == 0 for s in qb.stride()[:3])
            and all(t.data_ptr() % 16 == 0 for t in (qb, kb, vb))):
        qb, kb, vb = qb.contiguous(), kb.contiguous(), vb.contiguous()
    return qb, kb, vb


def attention_fwd_kernel(qb, kb, vb, mask):
    """Launch the forward kernel. qb, kb, vb: (B, T, H, d) bf16 views with
    equal strides and unit stride along d; mask: (B, T) bool contiguous or
    None. Returns (B, T, H, d) f32, contiguous."""
    B, T, H, d = qb.shape
    out = torch.empty((B, T, H, d), dtype=torch.float32, device=qb.device)
    sb, st, sh, _ = qb.stride()
    kernels.launch("attention_fwd", "attention", "attention_fwd", _FWD_ARGS,
                   qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), kernels.ptr(mask),
                   out.data_ptr(), B, T, H, d, sb, st, sh, d ** -0.5,
                   kernels.stream(qb))
    return out


def attention_bwd_kernel(qb, kb, vb, mask, g):
    """Launch the backward kernels for cotangent g (B, T, H, d) f32,
    contiguous. Returns (dq, dk, dv): bf16 views of one (B, T, 3, H, d)
    buffer. Past T 64 each row's max, denominator and sum(dp * p) pass from
    the dq launch to the dk, dv one through an f32 (3, B * H * T) scratch."""
    B, T, H, d = qb.shape
    dqkv = torch.empty((B, T, 3, H, d), dtype=_BF, device=qb.device)
    dq, dk, dv = dqkv.unbind(2)
    stats = (torch.empty((3, B * H * T), dtype=torch.float32, device=qb.device)
             if T > _SHORT_T else None)
    sb, st, sh, _ = qb.stride()
    kernels.launch("attention_bwd", "attention", "attention_bwd", _BWD_ARGS,
                   qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), kernels.ptr(mask),
                   g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   kernels.ptr(stats), B, T, H, d, sb, st, sh, d ** -0.5,
                   kernels.stream(qb))
    return dq, dk, dv


class _AttnCore(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op, with the
    signature of ``_AttnCorePlain``."""

    @staticmethod
    def forward(ctx, qb, kb, vb, key_mask):
        qb, kb, vb = _strided(qb, kb, vb)
        mask = None if key_mask is None else key_mask.to(torch.bool).contiguous()
        kernels.require_cuda(qb, kb, vb, *(() if mask is None else (mask,)),
                             contiguous=False)
        ctx.save_for_backward(qb, kb, vb)
        ctx.key_mask = mask
        return attention_fwd_kernel(qb, kb, vb, mask)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb = ctx.saved_tensors
        dq, dk, dv = attention_bwd_kernel(qb, kb, vb, ctx.key_mask,
                                          g.float().contiguous())
        return dq, dk, dv, None


def fused_attention_plain(q, k, v, key_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of ``fused_attention`` (same rounding points,
    forward and backward), on whatever device ``q`` lies."""
    return _AttnCorePlain.apply(q.to(_BF), k.to(_BF), v.to(_BF), key_mask)


def fused_attention(q, k, v, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d), invalid keys at -1e9) v per cloud and head:
    the kernels on CUDA tensors, the plain version on CPU ones.

    q, k, v: (B, T, H, d), cast to bf16 here; key_mask: optional (B, T)
    bool, True = valid key. Returns (B, T, H, d) f32."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, key_mask)
    B, T, H, d = q.shape
    if not kernel_takes(B, T, H, d):
        raise ValueError(f"fused_attention kernel is built for T >= 1 and d % 8 == 0 "
                         f"up to 256, got T={T}, d={d}")
    return _AttnCore.apply(q.to(_BF), k.to(_BF), v.to(_BF), key_mask)


def smem_bytes(T: int, d: int) -> tuple:
    """Dynamic shared memory (bytes) of the forward and the backward launch
    at sequence length T and head width d, as ``csrc/attention.cu`` sizes
    them. Needs the built library (a CUDA host)."""
    fn = kernels.library("attention").attention_smem_bytes
    fn.argtypes = [_I, _I, _I]
    fn.restype = ctypes.c_longlong
    return fn(T, d, 0), fn(T, d, 1)
