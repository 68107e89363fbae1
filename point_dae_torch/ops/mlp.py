"""The ViT block's MLP as kernels, each with its wrapper, autograd
function and plain version: the pre-norm sub-block ``y = x + s *
MLP(LN(x))`` (``fused_mlp_ln``) and the MLP alone (``fused_mlp``).

Port of ``point_dae_tpu/ops/pallas_mlp.py:fused_mlp_ln`` and
``fused_mlp``; the CUDA kernels are ``csrc/mlp.cu``. Numerics of every
version: LayerNorm in f32 with the flax eps (1e-6) and var = E[x^2] -
E[x]^2; matrix operands bf16 with f32 accumulation; exact-erf GELU in f32.
Gradients come back in the primals' types, as ``_mlp_ln_core_bwd`` and
``_mlp_core_bwd`` return them: ``fused_mlp_ln``'s dx, dgamma, dbeta, db1,
db2 in f32 and dk1, dk2 in bf16; ``fused_mlp``'s dx, dk1, dk2 in bf16 (its
x enters bf16) and db1, db2 in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import kernels

_ROW_PARTS = 8   # row partitions of the weight-gradient pass (csrc/mlp.cu, B)
_ONE_BLOCK_C = (128, 256, 384)   # csrc/mlp.cu's one-block form; wider rows the wide form


def supported(R: int, C: int, H: int, tt: int = 256) -> bool:
    """``pallas_mlp.supported``: the gate of ``layers.py:331-345``.
    ``kernel_takes`` holds on every shape inside it."""
    return R % tt == 0 and C % 128 == 0 and H % 128 == 0 and H >= C


def kernel_takes(R: int, C: int, H: int) -> bool:
    """The shapes the kernels are built for: rows, width and hidden width
    multiples of 64 (the one-block form at C 128, 256 and 384, the wide
    form at any other)."""
    return R > 0 and C > 0 and H > 0 and R % 64 == 0 and C % 64 == 0 and H % 64 == 0


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h * math.sqrt(0.5)))


def fused_mlp_ln_plain(x, gamma, beta, k1, b1, k2, b2, row_scale=None,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel (differentiable by autograd).
    x: (..., C) f32 residual stream; k1 (C, H), k2 (H, C) rounded to bf16;
    row_scale: optional (R,) per-row scale. Returns f32."""
    C = x.shape[-1]
    x2 = x.reshape(-1, C).float()
    mu = x2.mean(1, keepdim=True)
    var = (x2 * x2).mean(1, keepdim=True) - mu * mu
    hin = (x2 - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    bf = torch.bfloat16
    h = hin.to(bf).float() @ k1.to(bf).float() + b1.float()
    out = _gelu(h).to(bf).float() @ k2.to(bf).float() + b2.float()
    if row_scale is not None:
        out = out * row_scale.reshape(-1, 1).float()
    return (x2 + out).reshape(x.shape)


_P, _I, _F = kernels.P, kernels.I, kernels.F
_FWD_ARGS = (_P,) * 9 + (_I, _I, _I, _F, _P)
_BWD_ARGS = (_P,) * 19 + (_I, _I, _I, _I, _F, _P)


def mlp_ln_fwd_kernel(x, gamma, beta, k1b, b1, k2b, b2, sc, eps: float = 1e-6):
    """Launch the forward kernel. x (R, C) f32, gamma/beta (C,) f32, k1b
    (C, H) and k2b (H, C) bf16, b1 (H,), b2 (C,) f32, sc (R,) f32 or None;
    all contiguous on one CUDA device. Returns y (R, C) f32."""
    R, C = x.shape
    H = k1b.shape[1]
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), k1b.data_ptr(), b1.data_ptr(),
            k2b.data_ptr(), b2.data_ptr(), kernels.ptr(sc), y.data_ptr())
    if C in _ONE_BLOCK_C:
        kernels.launch("mlp_ln_fwd", "mlp", "mlp_ln_fwd", _FWD_ARGS, *ptrs, R, C, H, eps,
                       kernels.stream(x))
        return y
    hin_s = torch.empty((R, C), dtype=torch.bfloat16, device=x.device)
    a_s = torch.empty((R, H), dtype=torch.bfloat16, device=x.device)
    kernels.launch("mlp_ln_fwd", "mlp", "mlp_ln_fwd_wide", (_P,) * 11 + (_I, _I, _I, _F, _P),
                   *ptrs, hin_s.data_ptr(), a_s.data_ptr(), R, C, H, eps, kernels.stream(x))
    return y


def mlp_ln_bwd_kernel(x, gamma, beta, k1b, b1, k2b, sc, g, eps: float = 1e-6):
    """Launch the backward kernels for cotangent g (R, C) f32. Returns
    (dx, dgamma, dbeta, dk1 bf16, db1, dk2 bf16, db2)."""
    R, C = x.shape
    H = k1b.shape[1]
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    dx = torch.empty_like(x)
    hin_s = torch.empty((R, C), dtype=bf, device=dev)
    gbr_s = torch.empty((R, C), dtype=bf, device=dev)
    part_a = torch.empty((R // 64, 3, C), dtype=f32, device=dev)
    dk1 = torch.empty((C, H), dtype=bf, device=dev)
    dk2 = torch.empty((H, C), dtype=bf, device=dev)
    db1 = torch.empty((H,), dtype=f32, device=dev)
    dln = torch.empty((3, C), dtype=f32, device=dev)
    head = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), k1b.data_ptr(), b1.data_ptr(),
            k2b.data_ptr(), kernels.ptr(sc), g.data_ptr(), dx.data_ptr(), hin_s.data_ptr(),
            gbr_s.data_ptr())
    if C in _ONE_BLOCK_C:
        dk1p = torch.empty((_ROW_PARTS, C, H), dtype=f32, device=dev)
        dk2p = torch.empty((_ROW_PARTS, H, C), dtype=f32, device=dev)
        db1p = torch.empty((_ROW_PARTS, H), dtype=f32, device=dev)
        kernels.launch("mlp_ln_bwd", "mlp", "mlp_ln_bwd", _BWD_ARGS, *head,
                       part_a.data_ptr(), dk1p.data_ptr(), dk2p.data_ptr(), db1p.data_ptr(),
                       dk1.data_ptr(), dk2.data_ptr(), db1.data_ptr(), dln.data_ptr(),
                       R, C, H, _ROW_PARTS, eps, kernels.stream(x))
    else:
        dh_s = torch.empty((R, H), dtype=bf, device=dev)
        a_s = torch.empty((R, H), dtype=bf, device=dev)
        db1p = torch.empty((R // 64, H), dtype=f32, device=dev)
        dxin = torch.empty((R, C), dtype=f32, device=dev)
        kernels.launch("mlp_ln_bwd", "mlp", "mlp_ln_bwd_wide",
                       (_P,) * 20 + (_I, _I, _I, _F, _P), *head, dh_s.data_ptr(),
                       a_s.data_ptr(), db1p.data_ptr(), dxin.data_ptr(), part_a.data_ptr(),
                       dk1.data_ptr(), dk2.data_ptr(), db1.data_ptr(), dln.data_ptr(),
                       R, C, H, eps, kernels.stream(x))
    return dx, dln[0], dln[1], dk1, db1, dk2, dln[2]


class _MlpLn(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, x, gamma, beta, k1b, b1, k2b, b2, sc, eps):
        ctx.save_for_backward(x, gamma, beta, k1b, b1, k2b, sc)
        ctx.eps = eps
        return mlp_ln_fwd_kernel(x, gamma, beta, k1b, b1, k2b, b2, sc, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, k1b, b1, k2b, sc = ctx.saved_tensors
        grads = mlp_ln_bwd_kernel(x, gamma, beta, k1b, b1, k2b, sc,
                                  g.float().contiguous(), ctx.eps)
        return (*grads, None, None)


def fused_mlp_ln(x, gamma, beta, k1, b1, k2, b2,
                 row_scale: Optional[torch.Tensor] = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """y = x + s * (GELU(LN(x; gamma, beta) @ k1 + b1) @ k2 + b2): the
    kernels on CUDA tensors, the plain version on CPU ones.
    x: (..., C) f32; k1 (C, H), k2 (H, C) (cast to bf16 here, as the JAX
    wrapper casts them); row_scale: optional (R,) with R = x.numel() // C."""
    if x.device.type == "cpu":
        return fused_mlp_ln_plain(x, gamma, beta, k1, b1, k2, b2, row_scale, eps)
    C = x.shape[-1]
    H = k1.shape[1]
    x2 = x.reshape(-1, C).float().contiguous()
    if not kernel_takes(x2.shape[0], C, H):
        raise ValueError(f"fused_mlp_ln kernel is built for rows, C and H multiples of 64, "
                         f"got R={x2.shape[0]}, C={C}, H={H}")
    bf = torch.bfloat16
    args = [x2, gamma.float().contiguous(), beta.float().contiguous(),
            k1.to(bf).contiguous(), b1.float().contiguous(),
            k2.to(bf).contiguous(), b2.float().contiguous()]
    sc = None if row_scale is None else row_scale.reshape(-1).float().contiguous()
    kernels.require_cuda(*args, *([] if sc is None else [sc]))
    return _MlpLn.apply(*args, sc, eps).reshape(x.shape)


# ---------------------------------------------------------------- MLP alone


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    return (0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
            + h * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * h * h))


class _MlpPlain(torch.autograd.Function):
    """Plain PyTorch version of the ``mlp`` kernels on the core's primals
    (xb, k1b, k2b bf16; b1, b2 f32), its backward written out as
    ``pallas_mlp.py:_bwd_kernel`` computes it, with the same bf16 roundings."""

    @staticmethod
    def forward(ctx, xb, k1b, b1, k2b, b2):
        ctx.save_for_backward(xb, k1b, b1, k2b)
        h = xb.float() @ k1b.float() + b1
        return _gelu(h).to(torch.bfloat16).float() @ k2b.float() + b2

    @staticmethod
    def backward(ctx, g):
        xb, k1b, b1, k2b = ctx.saved_tensors
        bf = torch.bfloat16
        g = g.float()
        h = xb.float() @ k1b.float() + b1
        a = _gelu(h).to(bf).float()
        gb = g.to(bf).float()
        dh = (gb @ k2b.float().t()) * _gelu_grad(h)
        dhb = dh.to(bf).float()
        return ((dhb @ k1b.float().t()).to(bf), (xb.float().t() @ dhb).to(bf),
                dh.sum(0), (a.t() @ gb).to(bf), g.sum(0))


def mlp_fwd_kernel(xb, k1b, b1, k2b, b2):
    """Launch the forward kernel. xb (R, C), k1b (C, H), k2b (H, C) bf16;
    b1 (H,), b2 (C,) f32; all contiguous on one CUDA device. Returns (R, C)
    f32."""
    R, C = xb.shape
    H = k1b.shape[1]
    y = torch.empty((R, C), dtype=torch.float32, device=xb.device)
    ptrs = (xb.data_ptr(), k1b.data_ptr(), b1.data_ptr(), k2b.data_ptr(), b2.data_ptr(),
            y.data_ptr())
    if C in _ONE_BLOCK_C:
        kernels.launch("mlp_fwd", "mlp", "mlp_fwd", (_P,) * 6 + (_I, _I, _I, _P), *ptrs,
                       R, C, H, kernels.stream(xb))
        return y
    a_s = torch.empty((R, H), dtype=torch.bfloat16, device=xb.device)
    kernels.launch("mlp_fwd", "mlp", "mlp_fwd_wide", (_P,) * 7 + (_I, _I, _I, _P), *ptrs,
                   a_s.data_ptr(), R, C, H, kernels.stream(xb))
    return y


def mlp_bwd_kernel(xb, k1b, b1, k2b, g):
    """Launch the backward kernels for cotangent g (R, C) f32. Returns
    (dx bf16, dk1 bf16, db1, dk2 bf16, db2)."""
    R, C = xb.shape
    H = k1b.shape[1]
    dev = xb.device
    f32, bf = torch.float32, torch.bfloat16
    dx = torch.empty((R, C), dtype=bf, device=dev)
    gbr_s = torch.empty((R, C), dtype=bf, device=dev)
    part_a = torch.empty((R // 64, C), dtype=f32, device=dev)
    dk1 = torch.empty((C, H), dtype=bf, device=dev)
    dk2 = torch.empty((H, C), dtype=bf, device=dev)
    db1 = torch.empty((H,), dtype=f32, device=dev)
    db2 = torch.empty((C,), dtype=f32, device=dev)
    head = (xb.data_ptr(), k1b.data_ptr(), b1.data_ptr(), k2b.data_ptr(), g.data_ptr(),
            dx.data_ptr(), gbr_s.data_ptr())
    tail = (dk1.data_ptr(), dk2.data_ptr(), db1.data_ptr(), db2.data_ptr())
    if C in _ONE_BLOCK_C:
        dk1p = torch.empty((_ROW_PARTS, C, H), dtype=f32, device=dev)
        dk2p = torch.empty((_ROW_PARTS, H, C), dtype=f32, device=dev)
        db1p = torch.empty((_ROW_PARTS, H), dtype=f32, device=dev)
        kernels.launch("mlp_bwd", "mlp", "mlp_bwd", (_P,) * 15 + (_I,) * 4 + (_P,), *head,
                       part_a.data_ptr(), dk1p.data_ptr(), dk2p.data_ptr(), db1p.data_ptr(),
                       *tail, R, C, H, _ROW_PARTS, kernels.stream(xb))
    else:
        dh_s = torch.empty((R, H), dtype=bf, device=dev)
        a_s = torch.empty((R, H), dtype=bf, device=dev)
        db1p = torch.empty((R // 64, H), dtype=f32, device=dev)
        kernels.launch("mlp_bwd", "mlp", "mlp_bwd_wide", (_P,) * 15 + (_I,) * 3 + (_P,),
                       *head, dh_s.data_ptr(), a_s.data_ptr(), db1p.data_ptr(),
                       part_a.data_ptr(), *tail, R, C, H, kernels.stream(xb))
    return dx, dk1, db1, dk2, db2


class _Mlp(torch.autograd.Function):
    """The ``mlp`` forward and backward kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, xb, k1b, b1, k2b, b2):
        ctx.save_for_backward(xb, k1b, b1, k2b)
        return mlp_fwd_kernel(xb, k1b, b1, k2b, b2)

    @staticmethod
    def backward(ctx, g):
        xb, k1b, b1, k2b = ctx.saved_tensors
        return mlp_bwd_kernel(xb, k1b, b1, k2b, g.float().contiguous())


def _mlp_primals(x, k1, b1, k2, b2):
    """The core's primals, as ``pallas_mlp.fused_mlp`` casts them: x (..., C)
    to (R, C) bf16, the kernels to bf16, the biases to f32."""
    bf = torch.bfloat16
    return (x.reshape(-1, x.shape[-1]).to(bf).contiguous(), k1.to(bf).contiguous(),
            b1.float().contiguous(), k2.to(bf).contiguous(), b2.float().contiguous())


def fused_mlp_plain(x, k1, b1, k2, b2) -> torch.Tensor:
    """Plain PyTorch version of ``fused_mlp``: the kernels' arithmetic, the
    hidden in f32 and rounded to bf16 only as the second product's operand.
    Not the block's plain chain, which rounds bias and GELU to bf16."""
    return _MlpPlain.apply(*_mlp_primals(x, k1, b1, k2, b2)).reshape(x.shape)


def fused_mlp(x, k1, b1, k2, b2) -> torch.Tensor:
    """out = GELU(x @ k1 + b1) @ k2 + b2 in f32: the kernels on CUDA tensors,
    the plain version on CPU ones. x (..., C) any float type (rounded to
    bf16, as the JAX wrapper rounds it); k1 (C, H), k2 (H, C)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, k1, b1, k2, b2)
    C, H = x.shape[-1], k1.shape[1]
    R = x.numel() // C
    if not kernel_takes(R, C, H):
        raise ValueError(f"fused_mlp kernel is built for rows, C and H multiples of 64, "
                         f"got R={R}, C={C}, H={H}")
    args = _mlp_primals(x, k1, b1, k2, b2)
    kernels.require_cuda(*args)
    if any(args[i].data_ptr() % 16 for i in (0, 1, 3)):
        raise ValueError("fused_mlp kernel reads x, k1 and k2 in 16-byte vectors")
    return _Mlp.apply(*args).reshape(x.shape)
