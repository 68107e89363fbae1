"""Chamfer distances (port of ``point_dae_tpu/losses/chamfer.py``).

``nn_distance(x, y) -> (dist1, dist2, idx1, idx2)`` is the load-bearing
contract. On CUDA tensors its forward runs the patch-chamfer kernel for
many tiny sets and the tiled kernel for large ones (both in
``csrc/chamfer.cu``), and the matrix-expansion distances otherwise; its
backward is the gather-based recompute of
``chamfer.py:219-252``, with the scatter as a one-hot product for small
sets.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.geometry import pairwise_sqdist
from ..utils import kernels


def _nn_half_xla(x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_j ||x_i - y_j||^2 and its first argmin over the expansion
    distances (the JAX package's XLA path)."""
    d = pairwise_sqdist(x, y)
    idx = torch.argmin(d, dim=-1)
    return d.gather(-1, idx[..., None])[..., 0], idx.int()


def use_small_kernel(x: torch.Tensor, m: int) -> bool:
    """``chamfer._use_small_pallas`` with "on TPU" read as "on CUDA"."""
    b, n, d = x.shape
    return x.device.type == "cuda" and d == 3 and n <= 64 and m <= 64 and b >= 4096


def use_tiled_kernel(x: torch.Tensor, m: int) -> bool:
    """``chamfer._use_pallas`` with "on TPU" read as "on CUDA"."""
    return x.device.type == "cuda" and x.shape[1] * m >= 512 * 512


def nn_half_small_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of the patch-chamfer kernel. x (P, N, 3),
    y (P, M, 3) -> (dist (P, N), idx (P, N) int32, near (P, N, 3)), with
    coordinate-wise distances and the first index on ties."""
    x = x.float()
    y = y.float()
    dif = [x[:, :, None, c] - y[:, None, :, c] for c in range(3)]
    d = (dif[0] * dif[0] + dif[1] * dif[1]) + dif[2] * dif[2]
    idx = torch.argmin(d, dim=-1)
    dist = d.gather(-1, idx[..., None])[..., 0]
    near = torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))
    return dist, idx.int(), near


def nn_half_small(x: torch.Tensor, y: torch.Tensor):
    """The patch-chamfer kernel on CUDA tensors, its plain version on CPU
    ones. x (P, N<=64, 3), y (P, M<=64, 3) f32."""
    if x.device.type == "cpu":
        return nn_half_small_plain(x, y)
    x = x.detach().float().contiguous()
    y = y.detach().float().contiguous()
    kernels.require_cuda(x, y)
    P, N, _ = x.shape
    M = y.shape[1]
    if N > 64 or M > 64 or x.shape[2] != 3:
        raise ValueError(f"patch chamfer kernel takes sets of <= 64 3-D "
                         f"points, got {tuple(x.shape)} vs {tuple(y.shape)}")
    dist = torch.empty((P, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((P, N), dtype=torch.int32, device=x.device)
    near = torch.empty((P, N, 3), dtype=torch.float32, device=x.device)
    P_, I = kernels.P, kernels.I
    kernels.launch("nn_half_small", "chamfer", "nn_half_small",
                   (P_, P_, I, I, I, P_, P_, P_, P_), x.data_ptr(), y.data_ptr(),
                   P, N, M, dist.data_ptr(), idx.data_ptr(), near.data_ptr(),
                   kernels.stream(x))
    return dist, idx, near


def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], each product rounded and the sum taken
    left to right (the order the tiled kernel keeps)."""
    out = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c] * b[..., c]
    return out


def nn_half_tiled_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of the tiled kernel. x (B, N, D), y (B, M, D)
    -> (dist (B, N) clamped at 0, idx (B, N) int32): the expansion distance
    (xx - 2 x.y) + yy in f32 and its first argmin."""
    x = x.float()
    y = y.float()
    xx = _seq_dot(x, x)
    yy = _seq_dot(y, y)
    xy = _seq_dot(x[:, :, None, :], y[:, None, :, :])
    d = (xx[:, :, None] - 2.0 * xy) + yy[:, None, :]
    idx = torch.argmin(d, dim=-1)
    return d.gather(-1, idx[..., None])[..., 0].clamp_min(0.0), idx.int()


def nn_half_tiled(x: torch.Tensor, y: torch.Tensor):
    """The tiled chamfer kernel on CUDA tensors, its plain version on CPU
    ones. x (B, N, 3), y (B, M, 3) f32, sets of any size."""
    if x.device.type == "cpu":
        return nn_half_tiled_plain(x, y)
    if x.shape[2] != 3:
        raise ValueError(f"tiled chamfer kernel is built for 3-D points, got "
                         f"{tuple(x.shape)} vs {tuple(y.shape)}")
    x = x.detach().float().contiguous()
    y = y.detach().float().contiguous()
    kernels.require_cuda(x, y)
    B, N, _ = x.shape
    dist = torch.empty((B, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=x.device)
    P_, I = kernels.P, kernels.I
    kernels.launch("nn_half_tiled", "chamfer", "nn_half_tiled",
                   (P_, P_, I, I, I, P_, P_, P_), x.data_ptr(), y.data_ptr(),
                   B, N, y.shape[1], dist.data_ptr(), idx.data_ptr(),
                   kernels.stream(x))
    return dist, idx


def _nn_half(x: torch.Tensor, y: torch.Tensor):
    """(dist, idx, near-or-None) of one direction."""
    if use_small_kernel(x, y.shape[1]):
        return nn_half_small(x, y)
    if use_tiled_kernel(x, y.shape[1]):
        return nn_half_tiled(x, y) + (None,)
    d, i = _nn_half_xla(x, y)
    return d, i, None


def _scatter(idx: torch.Tensor, vals: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, S) idx, (B, S, D) vals -> (B, out_len, D) sums."""
    if out_len <= 256 and idx.shape[1] <= 256:
        onehot = torch.nn.functional.one_hot(idx.long(), out_len).to(vals.dtype)
        return torch.einsum("bsl,bsd->bld", onehot, vals)
    out = torch.zeros((vals.shape[0], out_len, vals.shape[2]), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(1, idx.long()[..., None].expand_as(vals), vals)


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1, y_near = _nn_half(xyz1, xyz2)
        d2, i2, x_near = _nn_half(xyz2, xyz1)
        if y_near is None:
            y_near = torch.gather(xyz2, 1, i1.long()[..., None].expand(-1, -1, xyz2.shape[2]))
            x_near = torch.gather(xyz1, 1, i2.long()[..., None].expand(-1, -1, xyz1.shape[2]))
        ctx.save_for_backward(xyz1, xyz2, i1, i2, y_near, x_near)
        ctx.mark_non_differentiable(i1, i2)
        return d1.clamp_min(0.0), d2.clamp_min(0.0), i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        xyz1, xyz2, i1, i2, y_near, x_near = ctx.saved_tensors
        gx_direct = g1[..., None] * (2.0 * (xyz1 - y_near))
        gy_direct = g2[..., None] * (2.0 * (xyz2 - x_near))
        gx = gx_direct + _scatter(i2, -gy_direct, xyz1.shape[1])
        gy = gy_direct + _scatter(i1, -gx_direct, xyz2.shape[1])
        return gx, gy


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, D), xyz2 (B, M, D) -> (dist1 (B, N), dist2 (B, M),
    idx1 (B, N), idx2 (B, M)), squared distances."""
    return _NNDistance.apply(xyz1, xyz2)


def chamfer_l2(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """mean(dist1) + mean(dist2) (ChamferDistanceL2)."""
    d1, d2, _, _ = nn_distance(xyz1, xyz2)
    return d1.mean() + d2.mean()


def masked_chamfer_l2(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Per-set chamfer-L2 over the leading axis, weighted: sum(w * per) /
    max(sum(w), 1e-8). xyz1/xyz2 (B, S, D), weight (B,)."""
    d1, d2, _, _ = nn_distance(xyz1, xyz2)
    per = d1.mean(-1) + d2.mean(-1)
    return (per * weight).sum() / weight.sum().clamp_min(1e-8)


LOSS_REGISTRY = {"cdl2": chamfer_l2}


def build_loss_func(loss_type: str):
    """The model-side loss switch; this slice ports ``cdl2``."""
    if loss_type not in LOSS_REGISTRY:
        raise NotImplementedError(f"loss {loss_type!r} (ported: cdl2)")
    return LOSS_REGISTRY[loss_type]
