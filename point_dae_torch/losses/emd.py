"""Approximate Earth Mover's Distance (port of ``point_dae_tpu/losses/emd.py``).

The reference's CUDA ``approxmatch`` (``extensions/emd/cuda/emd_kernel.cu:
26-158``) is an auction-style soft matching between two point sets: 10
rounds at temperatures ``level = -4^j`` for j = 7..-1, then ``level = 0``;
in each round the rows claim capacity against the columns' remaining
capacity, the columns scale back over-committed claims, and the committed
transport accumulates. The JAX package writes every round as three dense
(B, N, M) contractions in plain XLA, with no Pallas kernel; the port does
the same in plain PyTorch on the tensors' device. Used by the optional EMD
loss only, so it favours being right over being fast.
"""
from __future__ import annotations

import torch


def emd_approx(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The approximate match, xyz1 (B, N, D), xyz2 (B, M, D) -> (B, N, M)
    float32: ``match[b, i, j]`` is the mass moved between ``xyz1[b, i]``
    and ``xyz2[b, j]``. The capacities keep the reference's integer
    division (``multiR = n / m``). No gradient flows through the match."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if N >= M:
        multi_row, multi_col = 1.0, float(N // M)
    else:
        multi_row, multi_col = float(M // N), 1.0
    with torch.no_grad():
        a, b = xyz1.float(), xyz2.float()
        d = ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)
        match = torch.zeros((B, N, M), dtype=torch.float32, device=d.device)
        remain_row = torch.full((B, N), multi_row, dtype=torch.float32, device=d.device)
        remain_col = torch.full((B, M), multi_col, dtype=torch.float32, device=d.device)
        for level in [-(4.0 ** j) for j in range(7, -2, -1)] + [0.0]:
            e = torch.exp(level * d)
            # rows claim capacity against the columns' remaining capacity
            suml = torch.einsum("bnm,bm->bn", e, remain_col) + 1e-9
            ratio_row = remain_row / suml
            # columns scale back over-committed claims
            sumr = torch.einsum("bnm,bn->bm", e, ratio_row) * remain_col
            consumption = torch.clamp(remain_col / (sumr + 1e-9), max=1.0)
            ratio_col = consumption * remain_col
            remain_col = torch.clamp(remain_col - sumr, min=0.0)
            w = e * ratio_row[:, :, None] * ratio_col[:, None, :]
            match = match + w
            remain_row = torch.clamp(remain_row - w.sum(2), min=0.0)
    return match


def emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Transported squared-distance cost per cloud, (B,) (the reference's
    ``matchcost``): differentiable in both clouds through the distances,
    the match held constant, as the CUDA backward does."""
    match = emd_approx(xyz1, xyz2)
    d = ((xyz1[:, :, None, :] - xyz2[:, None, :, :]) ** 2).sum(-1)
    return (match * d).sum((1, 2))


def emd_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The reference wrapper (``extensions/emd/emd.py:31-49``): each cloud's
    cost over N1, then the mean over the batch."""
    return (emd_cost(xyz1, xyz2) / xyz1.shape[1]).mean()
