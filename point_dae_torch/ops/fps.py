"""Furthest point sampling: kernel wrapper, gate and plain version.

Port of ``point_dae_tpu/ops/pallas_fps.py`` (``fps_pallas_batched`` and
``fps_pallas``, one function in two TPU layouts); the CUDA kernel is
``csrc/fps.cu``. Conventions: the first pick is index 0, points with
``(x*x + y*y) + z*z <= 1e-3`` are never picked, each pick is the argmax of
the running min-distance over the selectable points (the others count as
-1), lowest index first on ties. Distances are computed coordinate-wise,
``(dx*dx + dy*dy) + dz*dz``, in that order and without fused multiply-adds,
in both versions, so their picks agree bit for bit.
"""
from __future__ import annotations

import torch

from ..utils import kernels

MAX_POINTS = 8192    # csrc/fps.cu: 1024 threads x 8 points in registers


def use_fps_kernel(device_type: str, n_points: int) -> bool:
    """The union of the two FPS gates of ``geometry.py:115-126`` (the
    batched kernel at N >= 512, N % 128 == 0; the per-row one at N >= 512,
    N % 8 == 0) with "on TPU" read as "on CUDA"."""
    return device_type == "cuda" and n_points >= 512 and n_points % 8 == 0


def furthest_point_sample_plain(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3) -> (B, n_samples)
    int32, on whatever device ``points`` lies."""
    points = points.detach().float()
    B, N, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    selectable = (x * x + y * y) + z * z > 1e-3
    min_d = torch.full((B, N), 1e10, dtype=torch.float32, device=points.device)
    neg = torch.full((), -1.0, device=points.device)
    out = torch.empty((B, n_samples), dtype=torch.long, device=points.device)
    last = torch.zeros(B, dtype=torch.long, device=points.device)
    for i in range(n_samples):
        out[:, i] = last
        p = points.gather(1, last[:, None, None].expand(B, 1, 3))
        dx, dy, dz = x - p[..., 0], y - p[..., 1], z - p[..., 2]
        min_d = torch.minimum(min_d, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(torch.where(selectable, min_d, neg), dim=1)
    return out.int()


def fps_kernel(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Launch the kernel. points: (B, N, 3) f32 contiguous on a CUDA device,
    N at most ``MAX_POINTS``. Returns (B, n_samples) int32."""
    kernels.require_cuda(points)
    B, N, D = points.shape
    if points.dtype != torch.float32 or D != 3 or not 1 <= N <= MAX_POINTS or n_samples < 1:
        raise ValueError(f"fps kernel is built for (B, N <= {MAX_POINTS}, 3) f32 and "
                         f"n_samples >= 1, got {tuple(points.shape)} {points.dtype}, "
                         f"{n_samples}")
    out = torch.empty((B, n_samples), dtype=torch.int32, device=points.device)
    P, I = kernels.P, kernels.I
    kernels.launch("fps", "fps", "fps", (P, I, I, I, P, P), points.data_ptr(), B, N,
                   n_samples, out.data_ptr(), kernels.stream(points))
    return out


def furthest_point_sample(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, N, 3) -> (B, n_samples) int32: the kernel on a CUDA tensor inside
    the gate (a cloud above ``MAX_POINTS`` there raises), the plain version
    on a CPU tensor or outside the gate."""
    B, N, _ = points.shape
    if not use_fps_kernel(points.device.type, N):
        return furthest_point_sample_plain(points, n_samples)
    if N > MAX_POINTS:
        raise NotImplementedError(
            f"fps kernel is built for at most {MAX_POINTS} points a cloud, got {N}")
    return fps_kernel(points.detach().float().contiguous(), n_samples)
