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
x enters bf16) and db1, db2 in f32. Both backwards, plain and kernel, round
where the TPU kernels round: bf16(LN(x)), bf16(s g), bf16(dh),
bf16(GELU(h)).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import kernels

_SMS = 132              # the H100's streaming multiprocessors
_WEIGHT_BLOCKS = 2      # blocks an SM of csrc/mlp.cu's weight-gradient launch
_ROW_BLOCK = 32         # rows a block of csrc/mlp.cu's backward row passes
_DUAL_ROWS = 128        # rows an output tile of csrc/mlp.cu's dual product


def supported(R: int, C: int, H: int, tt: int = 256) -> bool:
    """``pallas_mlp.supported``: the gate of ``layers.py:331-345``.
    ``kernel_takes`` holds on every shape inside it."""
    return R % tt == 0 and C % 128 == 0 and H % 128 == 0 and H >= C


def kernel_takes(R: int, C: int, H: int) -> bool:
    """The shapes the kernels are built for: rows, width and hidden width
    multiples of 64 (one forward and one backward for all)."""
    return R > 0 and C > 0 and H > 0 and R % 64 == 0 and C % 64 == 0 and H % 64 == 0


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h * math.sqrt(0.5)))


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    return (0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
            + h * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * h * h))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def weight_slices(R: int, C: int, H: int) -> int:
    """S, the slices into which the backward cuts the rows for its dk1 and
    dk2 products: 2 (C / 128) (H / 128) output tiles (rounded up) times S
    blocks at two an SM, the fewest waves times k tiles a slice, the
    fewer slices on a tie; every slice keeps at least one 64-row k tile,
    and the f32 partials stay within 64 MiB. A function of the shape
    alone, so that two calls sum in one order."""
    kt = R // 64
    tiles = 2 * _cdiv(C, 128) * _cdiv(H, 128)
    slots = _SMS * _WEIGHT_BLOCKS
    most = min(kt, 32, max(1, (16 << 20) // (2 * C * H)))
    best, S = None, 1
    for s in range(1, most + 1):
        cost = _cdiv(tiles * s, slots) * _cdiv(kt, s)
        if best is None or cost < best:
            best, S = cost, s
    return _cdiv(kt, _cdiv(kt, S))


def _ln_f32(x, gamma, beta, eps):
    """``pallas_mlp.py:_ln_fwd_f32``: (xhat, rsqrt(var + eps), LN(x))."""
    mu = x.mean(1, keepdim=True)
    var = (x * x).mean(1, keepdim=True) - mu * mu
    r = torch.rsqrt(var + eps)
    xhat = (x - mu) * r
    return xhat, r, xhat * gamma + beta


def _mlp_ln_fwd_plain(x, gamma, beta, k1b, b1, k2b, b2, sc, eps):
    hin = _ln_f32(x, gamma, beta, eps)[2]
    bf = torch.bfloat16
    h = hin.to(bf).float() @ k1b.float() + b1
    out = _gelu(h).to(bf).float() @ k2b.float() + b2
    if sc is not None:
        out = out * sc.reshape(-1, 1)
    return x + out


def mlp_ln_bwd_plain(x, gamma, beta, k1b, b1, k2b, sc, g, eps: float = 1e-6,
                     round_out: bool = True):
    """``pallas_mlp.py:_bwd_ln_kernel`` written out in PyTorch, with its
    rounding points: the twin of ``mlp_ln_bwd_kernel``. x, g (R, C) f32;
    gamma, beta (C,), b1 (H,) f32; k1b (C, H), k2b (H, C) bf16; sc (R,) f32
    or None. Returns (dx, dgamma, dbeta, dk1, db1, dk2, db2) in the kernel's
    types (dk1, dk2 bf16, the rest f32); with ``round_out=False`` dk1 and
    dk2 are the f32 sums before that rounding, as the Pallas kernel writes
    them."""
    bf = torch.bfloat16
    x, g = x.float(), g.float()
    xhat, r, hin = _ln_f32(x, gamma, beta, eps)
    hinb = hin.to(bf).float()
    h = hinb @ k1b.float() + b1
    a = _gelu(h).to(bf).float()
    gbr = g if sc is None else g * sc.reshape(-1, 1)
    gbrb = gbr.to(bf).float()
    dh = (gbrb @ k2b.float().t()) * _gelu_grad(h)
    dhb = dh.to(bf).float()
    dxin = dhb @ k1b.float().t()
    dxhat = dxin * gamma
    m1 = dxhat.mean(1, keepdim=True)
    m2 = (dxhat * xhat).mean(1, keepdim=True)
    dx = g + r * (dxhat - m1 - xhat * m2)
    dk1, dk2 = hinb.t() @ dhb, a.t() @ gbrb
    if round_out:
        dk1, dk2 = dk1.to(bf), dk2.to(bf)
    return dx, (dxin * xhat).sum(0), dxin.sum(0), dk1, dh.sum(0), dk2, gbr.sum(0)


class _MlpLnPlain(torch.autograd.Function):
    """Plain PyTorch version of the ``mlp_ln`` kernels on the core's primals
    (x, gamma, beta, b1, b2, sc f32; k1b, k2b bf16), its backward
    ``mlp_ln_bwd_plain``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, k1b, b1, k2b, b2, sc, eps):
        ctx.save_for_backward(x, gamma, beta, k1b, b1, k2b, sc)
        ctx.eps = eps
        return _mlp_ln_fwd_plain(x, gamma, beta, k1b, b1, k2b, b2, sc, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, k1b, b1, k2b, sc = ctx.saved_tensors
        return (*mlp_ln_bwd_plain(x, gamma, beta, k1b, b1, k2b, sc, g, ctx.eps), None, None)


def fused_mlp_ln_plain(x, gamma, beta, k1, b1, k2, b2, row_scale=None,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernels, forward and backward.
    x: (..., C) f32 residual stream; k1 (C, H), k2 (H, C) rounded to bf16;
    row_scale: optional (R,) per-row scale. Returns f32."""
    C = x.shape[-1]
    bf = torch.bfloat16
    sc = None if row_scale is None else row_scale.reshape(-1).float()
    y = _MlpLnPlain.apply(x.reshape(-1, C).float(), gamma.float(), beta.float(), k1.to(bf),
                          b1.float(), k2.to(bf), b2.float(), sc, eps)
    return y.reshape(x.shape)


_P, _I, _F = kernels.P, kernels.I, kernels.F


def _require_aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the mlp kernels read their inputs in 16-byte vectors")


def _bwd_scratch(R: int, C: int, H: int, dev):
    """The backward's scratch, freed when the call returns: gbr (R, C),
    dh and GELU(h) (R, H) bf16; db2 partials a row-pass block, db1 partials
    a dual-product tile, dk1 and dk2 partials a slice (f32)."""
    f32, bf = torch.float32, torch.bfloat16
    S = weight_slices(R, C, H)
    return S, (torch.empty((R, C), dtype=bf, device=dev),
               torch.empty((R, H), dtype=bf, device=dev),
               torch.empty((R, H), dtype=bf, device=dev),
               torch.empty((R // _ROW_BLOCK, C), dtype=f32, device=dev),
               torch.empty((_cdiv(R, _DUAL_ROWS), H), dtype=f32, device=dev),
               torch.empty((S, C, H), dtype=f32, device=dev),
               torch.empty((S, H, C), dtype=f32, device=dev))


def mlp_ln_fwd_kernel(x, gamma, beta, k1b, b1, k2b, b2, sc, eps: float = 1e-6):
    """Launch the forward kernels (LN rows, the hidden product, the output
    product; one count). x (R, C) f32, gamma/beta (C,) f32, k1b (C, H) and
    k2b (H, C) bf16, b1 (H,), b2 (C,) f32, sc (R,) f32 or None; all
    contiguous on one CUDA device. Returns y (R, C) f32."""
    R, C = x.shape
    H = k1b.shape[1]
    bf = torch.bfloat16
    _require_aligned(x, gamma, beta, k1b, k2b)
    y = torch.empty_like(x)
    hin = torch.empty((R, C), dtype=bf, device=x.device)
    a = torch.empty((R, H), dtype=bf, device=x.device)
    kernels.launch("mlp_ln_fwd", "mlp", "mlp_ln_fwd", (_P,) * 11 + (_I, _I, _I, _F, _P),
                   x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), k1b.data_ptr(),
                   b1.data_ptr(), k2b.data_ptr(), b2.data_ptr(), kernels.ptr(sc), y.data_ptr(),
                   hin.data_ptr(), a.data_ptr(), R, C, H, eps, kernels.stream(x))
    return y


def mlp_ln_bwd_kernel(x, gamma, beta, k1b, b1, k2b, sc, g, eps: float = 1e-6):
    """Launch the backward kernels (six launches, one count) for cotangent g
    (R, C) f32. Returns (dx, dgamma, dbeta, dk1 bf16, db1, dk2 bf16, db2)."""
    R, C = x.shape
    H = k1b.shape[1]
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    _require_aligned(x, gamma, beta, k1b, k2b, g)
    dx = torch.empty_like(x)
    dk1 = torch.empty((C, H), dtype=bf, device=dev)
    dk2 = torch.empty((H, C), dtype=bf, device=dev)
    db1 = torch.empty((H,), dtype=f32, device=dev)
    dln = torch.empty((3, C), dtype=f32, device=dev)
    S, (gbr, dh, a, part_b2, db1p, dk1p, dk2p) = _bwd_scratch(R, C, H, dev)
    hin = torch.empty((R, C), dtype=bf, device=dev)
    dxin = torch.empty((R, C), dtype=f32, device=dev)
    part_ln = torch.empty((R // _ROW_BLOCK, 2, C), dtype=f32, device=dev)
    kernels.launch("mlp_ln_bwd", "mlp", "mlp_ln_bwd", (_P,) * 23 + (_I,) * 4 + (_F, _P),
                   x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), k1b.data_ptr(),
                   b1.data_ptr(), k2b.data_ptr(), kernels.ptr(sc), g.data_ptr(),
                   dx.data_ptr(), dk1.data_ptr(), dk2.data_ptr(), db1.data_ptr(),
                   dln.data_ptr(), hin.data_ptr(), gbr.data_ptr(), dh.data_ptr(), a.data_ptr(),
                   dxin.data_ptr(), part_ln.data_ptr(), part_b2.data_ptr(), db1p.data_ptr(),
                   dk1p.data_ptr(), dk2p.data_ptr(), R, C, H, S, eps, kernels.stream(x))
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


def mlp_bwd_plain(xb, k1b, b1, k2b, g, round_out: bool = True):
    """``pallas_mlp.py:_bwd_kernel`` written out in PyTorch, with its
    rounding points: the twin of ``mlp_bwd_kernel``. xb (R, C), k1b (C, H),
    k2b (H, C) bf16; b1 (H,) and g (R, C) f32. Returns (dx, dk1, db1, dk2,
    db2): dx, dk1, dk2 bf16 as ``_mlp_core_bwd`` rounds them, or with
    ``round_out=False`` the f32 sums that the Pallas kernel writes."""
    bf = torch.bfloat16
    g = g.float()
    h = xb.float() @ k1b.float() + b1
    a = _gelu(h).to(bf).float()
    gb = g.to(bf).float()
    dh = (gb @ k2b.float().t()) * _gelu_grad(h)
    dhb = dh.to(bf).float()
    dx, dk1, dk2 = dhb @ k1b.float().t(), xb.float().t() @ dhb, a.t() @ gb
    if round_out:
        dx, dk1, dk2 = dx.to(bf), dk1.to(bf), dk2.to(bf)
    return dx, dk1, dh.sum(0), dk2, g.sum(0)


class _MlpPlain(torch.autograd.Function):
    """Plain PyTorch version of the ``mlp`` kernels on the core's primals
    (xb, k1b, k2b bf16; b1, b2 f32), its backward ``mlp_bwd_plain``."""

    @staticmethod
    def forward(ctx, xb, k1b, b1, k2b, b2):
        ctx.save_for_backward(xb, k1b, b1, k2b)
        h = xb.float() @ k1b.float() + b1
        return _gelu(h).to(torch.bfloat16).float() @ k2b.float() + b2

    @staticmethod
    def backward(ctx, g):
        xb, k1b, b1, k2b = ctx.saved_tensors
        return mlp_bwd_plain(xb, k1b, b1, k2b, g)


def mlp_fwd_kernel(xb, k1b, b1, k2b, b2):
    """Launch the forward kernels (the hidden product, the output product;
    one count). xb (R, C), k1b (C, H), k2b (H, C) bf16; b1 (H,), b2 (C,)
    f32; all contiguous on one CUDA device. Returns (R, C) f32."""
    R, C = xb.shape
    H = k1b.shape[1]
    _require_aligned(xb, k1b, k2b)
    y = torch.empty((R, C), dtype=torch.float32, device=xb.device)
    a = torch.empty((R, H), dtype=torch.bfloat16, device=xb.device)
    kernels.launch("mlp_fwd", "mlp", "mlp_fwd", (_P,) * 7 + (_I, _I, _I, _P), xb.data_ptr(),
                   k1b.data_ptr(), b1.data_ptr(), k2b.data_ptr(), b2.data_ptr(), y.data_ptr(),
                   a.data_ptr(), R, C, H, kernels.stream(xb))
    return y


def mlp_bwd_kernel(xb, k1b, b1, k2b, g):
    """Launch the backward kernels (five launches, one count) for cotangent g
    (R, C) f32. Returns (dx bf16, dk1 bf16, db1, dk2 bf16, db2)."""
    R, C = xb.shape
    H = k1b.shape[1]
    dev = xb.device
    f32, bf = torch.float32, torch.bfloat16
    _require_aligned(xb, k1b, k2b, g)
    dx = torch.empty((R, C), dtype=bf, device=dev)
    dk1 = torch.empty((C, H), dtype=bf, device=dev)
    dk2 = torch.empty((H, C), dtype=bf, device=dev)
    db1 = torch.empty((H,), dtype=f32, device=dev)
    db2 = torch.empty((C,), dtype=f32, device=dev)
    S, (gbr, dh, a, part_b2, db1p, dk1p, dk2p) = _bwd_scratch(R, C, H, dev)
    kernels.launch("mlp_bwd", "mlp", "mlp_bwd", (_P,) * 17 + (_I,) * 4 + (_P,),
                   xb.data_ptr(), k1b.data_ptr(), b1.data_ptr(), k2b.data_ptr(), g.data_ptr(),
                   dx.data_ptr(), dk1.data_ptr(), dk2.data_ptr(), db1.data_ptr(),
                   db2.data_ptr(), gbr.data_ptr(), dh.data_ptr(), a.data_ptr(),
                   part_b2.data_ptr(), db1p.data_ptr(), dk1p.data_ptr(), dk2p.data_ptr(),
                   R, C, H, S, kernels.stream(xb))
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
    return _Mlp.apply(*args).reshape(x.shape)
