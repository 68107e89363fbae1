"""Fused two-stage folding head: kernel wrappers, autograd functions and
plain version.

Port of ``point_dae_tpu/ops/pallas_folding.py:fused_folding``; the CUDA
kernels are ``csrc/folding.cu``. Every decoded token is expanded over an
n-point grid and run through two 3-layer MLPs whose first layer is split
into a per-token and a per-point half; the kernels keep the expanded
``(tokens * n, F)`` hiddens on chip in both passes.

Numerics of both versions (they are part of the function): every product
takes bf16 operands and accumulates in f32; bias adds and ReLUs are f32 and
only the next product's operand is rounded to bf16. The backward recomputes
the chain, rounds every cotangent to bf16 before each product, takes the
ReLU masks from the f32 activations, sums bias gradients from the unrounded
cotangents, and returns every gradient rounded to bf16 (the primals are
bf16 casts of f32 masters). This is not the strict bf16 chain of the plain
``SplitMLP`` path. The TPU kernel's 8-lane padding of the 2- and 3-wide
operands has no counterpart here.
"""
from __future__ import annotations

import torch

from ..utils import kernels

_BF = torch.bfloat16
_TOKEN_PAD = 64      # tokens are padded to a multiple of the GEMM tile (csrc/folding.cu, GT)
_MAX_F = 384         # widest hidden whose row tiles fit a block's shared memory
_ROWS_BWD = 80       # rows a block of the backward's rows pass owns (csrc/folding.cu, MR_BWD)


def supported(C: int, F: int, n: int) -> bool:
    """``pallas_folding.supported``: the shapes the fused head is taken for."""
    return C % 128 == 0 and F % 128 == 0 and 2 <= n <= 64


def stage_params(split_mlp):
    """``((k0, b0), (k1, b1), (k2, b2))`` of one folding stage from a
    ``SplitMLP`` (Dense layers at 0, 2, 4 with ``(out, in)`` weights):
    ``(in, out)`` kernels, ``k0`` in the concat layout ``(C + E, F)``."""
    return tuple((split_mlp[i].weight.t(), split_mlp[i].bias) for i in (0, 2, 4))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation."""
    return a.to(_BF).float() @ b.to(_BF).float()


def _recompute(n, xb, gp1, b01, ks1, k11, b11, k21, b21, ks2, ke2, b02, k12, b12):
    """The chain up to a3: f32 activations, bf16 product operands."""
    T, F = xb.shape[0], ks1.shape[1]
    sp1 = _dot(xb, ks1)                                            # (T, F)
    h0 = (gp1.float()[None] + sp1[:, None, :]) + b01.float()       # (T, n, F)
    a0 = torch.relu(h0).reshape(T * n, F)
    a1 = torch.relu(_dot(a0, k11) + b11.float())
    f1 = _dot(a1, k21) + b21.float()                               # (R, 3)
    sp2 = _dot(xb, ks2)
    h2 = (_dot(f1, ke2).reshape(T, n, F) + sp2[:, None, :]) + b02.float()
    a2 = torch.relu(h2).reshape(T * n, F)
    a3 = torch.relu(_dot(a2, k12) + b12.float())
    return a0, a1, f1, a2, a3


class _FoldCorePlain(torch.autograd.Function):
    """Plain PyTorch version of the forward and backward kernels.
    (T, C) bf16 tokens -> (T * n, 3) f32 folded points; every weight and
    bias operand is a bf16 cast, and every gradient comes back in bf16."""

    @staticmethod
    def forward(ctx, xb, gp1, b01, ks1, k11, b11, k21, b21, ks2, ke2, b02, k12, b12,
                k22, b22):
        ctx.save_for_backward(xb, gp1, b01, ks1, k11, b11, k21, b21, ks2, ke2, b02,
                              k12, b12, k22, b22)
        n = gp1.shape[0]
        *_, a3 = _recompute(n, xb, gp1, b01, ks1, k11, b11, k21, b21, ks2, ke2, b02,
                            k12, b12)
        return _dot(a3, k22) + b22.float()

    @staticmethod
    def backward(ctx, g):
        (xb, gp1, b01, ks1, k11, b11, k21, b21, ks2, ke2, b02, k12, b12, k22,
         b22) = ctx.saved_tensors
        n, F = gp1.shape
        T = xb.shape[0]
        a0, a1, f1, a2, a3 = _recompute(n, xb, gp1, b01, ks1, k11, b11, k21, b21,
                                        ks2, ke2, b02, k12, b12)
        g = g.float()
        zero = torch.zeros((), dtype=torch.float32, device=g.device)
        # stage 2, dense2: out = a3 @ k22 + b22
        dk22 = _dot(a3.t(), g)
        dh3 = torch.where(a3 > 0, _dot(g, k22.t()), zero)
        db12 = dh3.sum(0)
        # stage 2, dense1: h3 = a2 @ k12 + b12
        dk12 = _dot(a2.t(), dh3)
        dh2 = torch.where(a2 > 0, _dot(dh3, k12.t()), zero)
        db02 = dh2.sum(0)
        # stage 2, dense0 (split): h2 = f1 @ ke2 + x @ ks2 + b02
        dsp2 = dh2.reshape(T, n, F).sum(1)
        dks2 = _dot(xb.t(), dsp2)
        dx = _dot(dsp2, ks2.t())
        dke2 = _dot(f1.t(), dh2)
        df1 = _dot(dh2, ke2.t())
        db21 = df1.sum(0)
        # stage 1, dense2: f1 = a1 @ k21 + b21
        dk21 = _dot(a1.t(), df1)
        dh1 = torch.where(a1 > 0, _dot(df1, k21.t()), zero)
        db11 = dh1.sum(0)
        # stage 1, dense1: h1 = a0 @ k11 + b11
        dk11 = _dot(a0.t(), dh1)
        dh0 = torch.where(a0 > 0, _dot(dh1, k11.t()), zero).reshape(T, n, F)
        # stage 1, dense0 (split): h0 = gp1 + x @ ks1 + b01
        dgp1 = dh0.sum(0)
        dsp1 = dh0.sum(1)
        dks1 = _dot(xb.t(), dsp1)
        dx = dx + _dot(dsp1, ks1.t())
        grads = (dx, dgp1, dgp1.sum(0), dks1, dk11, db11, dk21, db21, dks2, dke2,
                 db02, dk12, db12, dk22, g.sum(0))
        return tuple(t.to(_BF) for t in grads)


_P, _I = kernels.P, kernels.I
_FWD_ARGS = (_P,) * 8 + (_I,) * 4 + (_P,)
_BWD_ARGS = (_P,) * 20 + (_I,) * 6 + (_P,)


def _pack_small(F, b01, b11, k21, b21, ke2, b02, b12, k22, b22) -> torch.Tensor:
    """The f32 vector of the narrow operands (values already bf16-rounded):
    b01 | b11 | b02 | b12 | k21 (F, 3) | k22 (F, 3) | ke2 (3, F) | b21 + 0 |
    b22 + 0 -- ``13 F + 8`` floats, the layout ``csrc/folding.cu`` reads."""
    pad = b21.new_zeros(1)
    parts = (b01, b11, b02, b12, k21.reshape(-1), k22.reshape(-1),
             ke2.reshape(-1), b21, pad, b22, pad)
    small = torch.cat([p.float() for p in parts]).contiguous()
    assert small.numel() == 13 * F + 8
    return small


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t.contiguous()
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


def folding_fwd_kernel(xb, ksc, gp1, k11, k12, small):
    """Launch the forward kernels. xb (Tp, C) bf16 with Tp % 64 == 0, ksc
    (C, 2F) bf16 = [ks1 | ks2], gp1 (n, F), k11 and k12 (F, F) bf16, small
    the ``_pack_small`` vector. Returns (Tp * n, 3) f32."""
    Tp, C = xb.shape
    n, F = gp1.shape
    dev = xb.device
    sp = torch.empty((Tp, 2 * F), dtype=torch.float32, device=dev)
    out = torch.empty((Tp * n, 3), dtype=torch.float32, device=dev)
    kernels.launch("folding_fwd", "folding", "folding_fwd", _FWD_ARGS,
                   xb.data_ptr(), ksc.data_ptr(), gp1.data_ptr(), k11.data_ptr(),
                   k12.data_ptr(), small.data_ptr(), sp.data_ptr(), out.data_ptr(),
                   Tp, C, F, n, kernels.stream(xb))
    return out


def folding_bwd_kernel(xb, ksc, gp1, k11, k12, small, g):
    """Launch the backward kernels for cotangent g (Tp * n, 3) f32. Returns
    f32 sums ``(dx (Tp, C), dksc (C, 2F), rows, dk (2, F, F))`` with rows =
    dgp1 (n, F) | db02 (F) | dke2 (3, F) | db12 (F) | dk22 (F, 3) | db11 (F) |
    dk21 (F, 3) | db21 (3) + 0 and dk = dk11, dk12. The scratch is 3-wide or
    one bit an element, apart from one (80, F) bf16 slot a block."""
    Tp, C = xb.shape
    n, F = gp1.shape
    dev = xb.device
    f32 = torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms                                   # rows pass: one a multiprocessor
    parts = max(1, 2 * sms // (2 * (F // 128) ** 2))   # weights pass: two a multiprocessor
    na = n * F + 12 * F + 4
    R = Tp * n

    def empty(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    sp, f1s, df1s = empty((Tp, 2 * F)), empty((R, 4)), empty((R, 4))
    m1, m3 = empty((R, F // 32), torch.int32), empty((R, F // 32), torch.int32)
    a1s = empty((blocks, _ROWS_BWD, F), _BF)
    dspb = empty((Tp, 2 * F), _BF)
    part_a = torch.zeros((blocks, na), dtype=f32, device=dev)
    dkp = empty((2, parts, F, F))
    dx, dksc, rows, dk = empty((Tp, C)), empty((C, 2 * F)), empty((na,)), empty((2, F, F))
    kernels.launch("folding_bwd", "folding", "folding_bwd", _BWD_ARGS,
                   xb.data_ptr(), ksc.data_ptr(), gp1.data_ptr(), k11.data_ptr(),
                   k12.data_ptr(), small.data_ptr(), g.data_ptr(), sp.data_ptr(),
                   f1s.data_ptr(), df1s.data_ptr(), m1.data_ptr(), m3.data_ptr(),
                   a1s.data_ptr(), dspb.data_ptr(), part_a.data_ptr(), dkp.data_ptr(),
                   dx.data_ptr(), dksc.data_ptr(), rows.data_ptr(), dk.data_ptr(),
                   Tp, C, F, n, blocks, parts, kernels.stream(xb))
    return dx, dksc, rows, dk


def kernel_operands(xb, gp1, b01, ks1, k11, b11, k21, b21, ks2, ke2, b02, k12, b12,
                    k22, b22):
    """The kernels' operands ``(xp, ksc, gp1, k11, k12, small)`` from the
    fifteen bf16 operands of the core: tokens zero-padded to a multiple of
    64, the two per-token kernels side by side, the narrow ones packed."""
    Tp = -(-xb.shape[0] // _TOKEN_PAD) * _TOKEN_PAD
    ksc = torch.cat([ks1, ks2], dim=1).contiguous()
    small = _pack_small(gp1.shape[1], b01, b11, k21, b21, ke2, b02, b12, k22, b22)
    return (_pad_rows(xb, Tp), ksc, gp1.contiguous(), k11.contiguous(),
            k12.contiguous(), small)


class _FoldCore(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op, with the
    signature of ``_FoldCorePlain``."""

    @staticmethod
    def forward(ctx, *core):
        ops = kernel_operands(*core)
        kernels.require_cuda(*ops)
        ctx.save_for_backward(*ops)
        ctx.tokens = T = core[0].shape[0]
        return folding_fwd_kernel(*ops)[: T * core[1].shape[0]]

    @staticmethod
    def backward(ctx, g):
        xp, ksc, gp1, k11, k12, small = ctx.saved_tensors
        T, Tp = ctx.tokens, xp.shape[0]
        n, F = gp1.shape
        g = g.float()
        dx, dksc, rows, dk = folding_bwd_kernel(
            xp, ksc, gp1, k11, k12, small, _pad_rows(g, Tp * n))
        dgp1 = rows[: n * F].reshape(n, F)
        db02, dke2, db12, dk22, db11, dk21, db21 = rows[n * F:].split(
            (F, 3 * F, F, 3 * F, F, 3 * F, 4))
        grads = (dx[:T], dgp1, dgp1.sum(0), dksc[:, :F], dk[0], db11,
                 dk21.reshape(F, 3), db21[:3], dksc[:, F:], dke2.reshape(3, F),
                 db02, dk[1], db12, dk22.reshape(F, 3), g.sum(0))
        return tuple(t.to(_BF) for t in grads)


def core_operands(x, grid, p1, p2):
    """The fifteen bf16 operands of the core, as ``_fold_core`` takes them."""
    (k01, b01), (k11, b11), (k21, b21) = p1
    (k02, b02), (k12, b12), (k22, b22) = p2
    C = x.shape[-1]
    ks1, ke1 = k01[:C].to(_BF), k01[C:].to(_BF)
    ks2, ke2 = k02[:C].to(_BF), k02[C:].to(_BF)
    # stage 1's per-point half does not depend on the token: grid @ ke1 once
    gp1 = _dot(grid, ke1).to(_BF)                                  # (n, F)
    return (x.reshape(-1, C).to(_BF), gp1, b01.to(_BF), ks1, k11.to(_BF),
            b11.to(_BF), k21.to(_BF), b21.to(_BF), ks2, ke2, b02.to(_BF),
            k12.to(_BF), b12.to(_BF), k22.to(_BF), b22.to(_BF))


def fused_folding_plain(x, grid, p1, p2) -> torch.Tensor:
    """Plain PyTorch version of ``fused_folding`` (same rounding points,
    forward and backward), on whatever device ``x`` lies."""
    B, M, _ = x.shape
    out = _FoldCorePlain.apply(*core_operands(x, grid, p1, p2))
    return out.reshape(B, M, grid.shape[0], 3)


def fused_folding(x, grid, p1, p2) -> torch.Tensor:
    """Two-stage folding head: the kernels on CUDA tensors, the plain
    version on CPU ones.

    x: (B, M, C) tokens; grid: (n, 2); p1, p2: ``((k0, b0), (k1, b1),
    (k2, b2))`` f32 parameters of each stage with ``(in, out)`` kernels, k0
    in the concat layout ``(C + E, F)`` (``stage_params``). Returns
    (B, M, n, 3) f32."""
    if x.device.type == "cpu":
        return fused_folding_plain(x, grid, p1, p2)
    B, M, C = x.shape
    n, F = grid.shape[0], p1[1][0].shape[0]
    if not supported(C, F, n) or F > _MAX_F:
        raise ValueError(f"fused_folding kernel is built for C % 128 == 0, F in "
                         f"(128, 256, 384) and 2 <= n <= 64, got C={C}, F={F}, n={n}")
    out = _FoldCore.apply(*core_operands(x, grid, p1, p2))
    return out.reshape(B, M, n, 3)
