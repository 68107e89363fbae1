"""DGCNN encoders (port of ``point_dae_tpu/models/dgcnn.py:25-340``): the
pretrain and classification encoder and the part-segmentation one.

Channel-last throughout. Torch names follow the reference
(``dgcnn_encoder.conv{1-5}.0.weight``, ``dgcnn_encoder.bn{1-5}.*``): every
``impl`` shares one set of parameters, the (out, 2C) edge-projection weight
over ``concat(neighbour - self, self)``.

``impl`` selects the EdgeConv: ``reference`` (edge tensor + Dense),
``fused`` (split projection + gathered aggregates), ``fused_pallas`` (split
projection + the fused kNN / aggregate kernel of ``ops/edgeconv.py``) or
``auto`` (``fused_pallas`` on a CUDA tensor, ``reference`` on a CPU one).
``knn_impl`` picks the kNN of the kernel path: ``kernel`` (in the fused
kernel) or ``xla``, the hybrid of ``PDAE_EDGECONV_KNN=xla`` in the JAX
package: ``ops/geometry.knn`` (the kNN kernel inside its gate, a sort
outside it) and then ``aggregate_from_idx``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.edgeconv import (aggregate_from_idx, aggregate_from_idx_plain, knn_aggregate,
                            knn_aggregate_plain, knn_aggregate_xla, supported)
from ..ops.gather import gather_rows
from ..ops.geometry import knn
from .layers import BatchNorm, Dense, checkpointed, leaky_relu02


def get_graph_feature(x: torch.Tensor, k: int = 20,
                      idx: Optional[torch.Tensor] = None, dtype=None) -> torch.Tensor:
    """Edge features: x (B, N, C) -> (B, N, k, 2C) =
    concat(neighbour - self, self). The kNN runs on the f32 input; ``dtype``
    applies to the gathered edge tensor only."""
    if idx is None:
        _, idx = knn(x, x, k)
    B, N, C = x.shape
    if dtype is not None:
        x = x.to(dtype)
    feature = gather_rows(x, idx.reshape(B, N * k)).reshape(B, N, k, C)
    center = x[:, :, None, :].expand(B, N, k, C)
    return torch.cat([feature - center, center], dim=-1)


def edge_conv(x: torch.Tensor, conv: Dense, bn: BatchNorm, k: int, dtype,
              idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``reference`` EdgeConv: graph feature -> pointwise Dense + BN (f32
    statistics) + LeakyReLU -> max over the neighbours."""
    h = get_graph_feature(x, k, idx=idx, dtype=dtype)
    return leaky_relu02(bn(conv(h))).amax(dim=2)


def fused_edge_conv(x: torch.Tensor, conv: Dense, bn: BatchNorm, k: int, dtype,
                    use_pallas: bool = True, interpret: bool = False,
                    exact_grads: bool = False, grad_mode: str = "first",
                    knn_impl: str = "kernel") -> torch.Tensor:
    """EdgeConv without the (B, N, k, 2C) edge tensor or the (B, N, N)
    distance matrix in device memory: W [x_j - x_i ; x_i] = U_j + V_i with
    U = x W_top, V = x (W_bot - W_top); the fused kernel returns max, min,
    sum and sum of squares of U over each point's neighbours; the BatchNorm
    batch statistics are rebuilt from those (and move ``bn``'s running
    statistics as ``BatchNorm`` does); since BN + LeakyReLU is monotone per
    channel, the max (scale >= 0) or the min (scale < 0) survives.

    ``use_pallas=False`` aggregates by gather instead of the kernel,
    ``interpret`` takes the kernel's path with its plain version on any
    device, ``exact_grads`` switches the backward to ``split``, ``knn_impl
    == "xla"`` takes the hybrid kNN + ``aggregate_from_idx`` on the kernel
    path."""
    B, N, C = x.shape
    dt = dtype or x.dtype
    wt = conv.weight[:, :C].to(dt)
    wc = conv.weight[:, C:].to(dt)
    xd = x.to(dt)
    Uf = torch.matmul(xd, wt.t()).float()
    Vf = torch.matmul(xd, (wc - wt).t()).float()
    xf = x.detach().float()
    if interpret or (use_pallas and supported(N, k) and x.device.type == "cuda"):
        mode = "split" if exact_grads else grad_mode
        if knn_impl == "xla":
            fn = aggregate_from_idx_plain if interpret else aggregate_from_idx
            M, m, S1, S2 = fn(Uf, knn(xf, xf, k)[1], mode)
        else:
            fn = knn_aggregate_plain if interpret else knn_aggregate
            M, m, S1, S2, _ = fn(Uf, xf, k, mode)
    else:
        M, m, S1, S2 = knn_aggregate_xla(Uf, knn(xf, xf, k)[1])

    if bn.training:
        cnt = B * N * k
        mean = (S1.sum((0, 1)) + k * Vf.sum((0, 1))) / cnt
        sum_h2 = (S2.sum((0, 1)) + 2.0 * (Vf * S1).sum((0, 1))
                  + k * (Vf * Vf).sum((0, 1)))
        var = sum_h2 / cnt - mean * mean
        bn.update_running(mean, var)
    else:
        mean, var = bn.running_mean, bn.running_var
    sel = Vf + torch.where(bn.weight >= 0, M, m)
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    return leaky_relu02((sel - mean) * inv + bn.bias)


class EdgeConv(nn.Module):
    """One ``reference`` EdgeConv with its own parameters: ``conv`` (out, 2C)
    without bias and ``bn``."""

    def __init__(self, in_dim: int, out_dim: int, k: int = 20, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.dtype = k, dtype
        self.conv = Dense(2 * in_dim, out_dim, bias=False, dtype=dtype,
                          generator=generator)
        self.bn = BatchNorm(out_dim)

    def forward(self, x: torch.Tensor, idx: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return edge_conv(x, self.conv, self.bn, self.k, self.dtype, idx=idx)


class FusedEdgeConv(EdgeConv):
    """``fused_edge_conv`` over the same parameters as ``EdgeConv``."""

    def __init__(self, in_dim: int, out_dim: int, k: int = 20, dtype=None,
                 generator: Optional[torch.Generator] = None, **flags):
        super().__init__(in_dim, out_dim, k, dtype, generator)
        self.flags = flags

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_edge_conv(x, self.conv, self.bn, self.k, self.dtype,
                               **self.flags)


class _Conv(nn.ModuleList):
    """The reference's ``convN`` Sequential, of which the port keeps entry
    ``0``, the bias-free projection."""

    def __init__(self, din: int, dout: int, dtype, generator):
        super().__init__([Dense(din, dout, bias=False, dtype=dtype, generator=generator)])


class DGCNNEncoder(nn.Module):
    """Four EdgeConvs (64, 64, 128, 256), a 512 -> 1024 fuse with BatchNorm
    and LeakyReLU, and a max over the points. x (B, N, 3) ->
    (global feature (B, 1024), pointwise (B, N, 1024)).

    ``remat`` recomputes each EdgeConv in the backward (JAX
    ``dgcnn.py:266-290``): the fused layouts the whole layer, the reference
    layout only gather, product and max, its kNN hoisted out as indices
    without a gradient. The BatchNorm running statistics move once."""

    WIDTHS = (64, 64, 128, 256)

    def __init__(self, k: int = 20, remat: bool = False, dtype=None,
                 impl: str = "reference", exact_grads: bool = False,
                 grad_mode: str = "first", knn_impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if impl not in ("reference", "fused", "fused_pallas", "auto"):
            raise ValueError(f"edgeconv_impl {impl!r}")
        if knn_impl not in ("kernel", "xla"):
            raise ValueError(f"edgeconv_knn {knn_impl!r}")
        self.k, self.dtype, self.impl, self.remat = k, dtype, impl, remat
        self.fused_flags = dict(exact_grads=exact_grads, grad_mode=grad_mode,
                                knn_impl=knn_impl)
        din = 3
        for i, width in enumerate(self.WIDTHS, start=1):
            setattr(self, f"conv{i}", _Conv(2 * din, width, dtype, generator))
            setattr(self, f"bn{i}", BatchNorm(width))
            din = width
        self.conv5 = _Conv(sum(self.WIDTHS), 1024, dtype, generator)
        self.bn5 = BatchNorm(1024)

    def resolved_impl(self, x: torch.Tensor) -> str:
        if self.impl != "auto":
            return self.impl
        return "fused_pallas" if x.device.type == "cuda" else "reference"

    def _edge_conv(self, i: int, impl: str, x: torch.Tensor,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv, bn = getattr(self, f"conv{i}")[0], getattr(self, f"bn{i}")
        if impl == "reference":
            return edge_conv(x, conv, bn, self.k, self.dtype, idx=idx)
        return fused_edge_conv(x, conv, bn, self.k, self.dtype,
                               use_pallas=impl == "fused_pallas", **self.fused_flags)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        impl = self.resolved_impl(x)
        feats = []
        for i in range(1, len(self.WIDTHS) + 1):
            layer = functools.partial(self._edge_conv, i, impl)
            if self.remat and impl == "reference":
                xd = x.detach()
                x = checkpointed(layer, x, knn(xd, xd, self.k)[1])
            elif self.remat:
                x = checkpointed(layer, x)
            else:
                x = layer(x)
            feats.append(x)
        h = leaky_relu02(self.bn5(self.conv5[0](torch.cat(feats, dim=-1))))
        return h.amax(dim=1), h


class DGCNNPartSegEncoder(nn.Module):
    """The segmentation DGCNN (JAX ``dgcnn.py:305-340``): three EdgeConv stages
    through ``get_graph_feature`` (the edge tensor, the row gather whose
    backward is the scatter kernel), of widths (64, 64), (64, 64) and (64,),
    each Dense + BatchNorm + LeakyReLU then a max over the neighbours; a
    192 -> 1024 fuse with BatchNorm and LeakyReLU and a max over the points.
    f32 throughout. Torch names follow the reference: ``conv{1-5}.0`` and
    ``bn{1-5}`` for the five stage convolutions in order (flax
    ``s1_conv0, s1_conv1, s2_conv0, s2_conv1, s3_conv0``), ``conv6.0`` and
    ``bn6``. x (B, N, 3) -> (global (B, 1024), pointwise (B, N, 1024)) and,
    with ``return_stages``, the stage features (x1, x2, x3), (B, N, 64) each."""

    STAGES = ((64, 64), (64, 64), (64,))

    def __init__(self, k: int = 20, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        din, i = 3, 1
        for dims in self.STAGES:
            d = 2 * din
            for width in dims:
                setattr(self, f"conv{i}", _Conv(d, width, None, generator))
                setattr(self, f"bn{i}", BatchNorm(width))
                d, i = width, i + 1
            din = dims[-1]
        self.conv6 = _Conv(sum(dims[-1] for dims in self.STAGES), 1024, None, generator)
        self.bn6 = BatchNorm(1024)

    def forward(self, x: torch.Tensor, return_stages: bool = False):
        i, stages = 1, []
        for dims in self.STAGES:
            h = get_graph_feature(x, self.k)
            for _ in dims:
                h = leaky_relu02(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")[0](h)))
                i += 1
            x = h.amax(dim=2)
            stages.append(x)
        h = leaky_relu02(self.bn6(self.conv6[0](torch.cat(stages, dim=-1))))
        if return_stages:
            return h.amax(dim=1), h, tuple(stages)
        return h.amax(dim=1), h
