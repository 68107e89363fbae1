"""Fused FPS + kNN patchify: kernel wrapper and its plain version.

Port of ``point_dae_tpu/ops/pallas_patchify.py:fused_patchify_pallas``; the
CUDA kernel is ``csrc/patchify.cu``: an FPS launch on the loop of
``csrc/fps_loop.cuh`` (the fps kernel's, with ``ops/fps.py:plan``'s launch),
then a launch of the B*G kNN rows over the whole card. Conventions: the first FPS pick is
index 0, points with |p|^2 <= 1e-3 are never picked, kNN rows ascend by
distance with the lower index first on ties. Distances are computed
coordinate-wise, ``(x-px)^2 + (y-py)^2 + (z-pz)^2``, in that order and
without fused multiply-adds, in both versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils import kernels
from . import fps


def fps_rows(points: torch.Tensor, n_samples: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Furthest point sampling that also returns every iteration's distance
    row. points: (B, N, 3) -> (idx (B, n) int32, rows (B, n, N) f32)."""
    points = points.float()
    B, N, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    selectable = (x * x + y * y) + z * z > 1e-3
    min_d = torch.full((B, N), 1e10, dtype=torch.float32, device=points.device)
    last = torch.zeros(B, dtype=torch.long, device=points.device)
    picks, rows = [], []
    for _ in range(n_samples):
        picks.append(last)
        p = points.gather(1, last[:, None, None].expand(B, 1, 3))
        dx, dy, dz = x - p[..., 0], y - p[..., 1], z - p[..., 2]
        d = (dx * dx + dy * dy) + dz * dz
        rows.append(d)
        min_d = torch.minimum(min_d, d)
        cand = torch.where(selectable, min_d, torch.full_like(min_d, -1.0))
        last = torch.argmax(cand, dim=1)     # first index on ties
    return torch.stack(picks, 1).int(), torch.stack(rows, 1)


def fused_patchify_plain(points: torch.Tensor, num_group: int,
                         group_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (B, N, 3) -> (fps_idx (B, G),
    knn_idx (B, G, S)), both int32."""
    fps_idx, rows = fps_rows(points, num_group)
    order = torch.sort(rows, dim=-1, stable=True).indices
    return fps_idx, order[..., :group_size].int()


MAX_POINTS = 232448 // 12   # csrc/patchify.cu: a kNN row above 2048 points stages the cloud


def kernel_takes(n_points: int, group_size: int) -> bool:
    """The shapes ``csrc/patchify.cu`` takes: kNN rows in registers up to
    2048 points, from the cloud staged in shared memory up to ``MAX_POINTS``."""
    return 1 <= group_size <= n_points <= MAX_POINTS


def fused_patchify(points: torch.Tensor, num_group: int, group_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patchify kernel on a CUDA tensor, its plain version on a CPU one.
    One call counts one ``patchify`` launch and runs two kernels, the FPS
    phase under ``fps.plan``'s launch."""
    if points.device.type == "cpu":
        return fused_patchify_plain(points, num_group, group_size)
    pts = points.detach().float().contiguous()
    kernels.require_cuda(pts)
    B, N, _ = pts.shape
    if not kernel_takes(N, group_size) or num_group < 1:
        raise ValueError(f"patchify kernel takes 1 <= S <= N <= {MAX_POINTS}, got N {N}, "
                         f"G {num_group}, S {group_size}")
    p = fps.plan(B, N, *fps.card(pts.device))
    fps_idx = torch.empty((B, num_group), dtype=torch.int32, device=pts.device)
    knn_idx = torch.empty((B, num_group, group_size), dtype=torch.int32,
                          device=pts.device)
    P, I = kernels.P, kernels.I
    kernels.launch("patchify", "patchify", "patchify", (P, I, I, I, I, I, I, I, P, P, P),
                   pts.data_ptr(), B, N, num_group, group_size, p.cluster, p.threads, p.ppt,
                   fps_idx.data_ptr(), knn_idx.data_ptr(), kernels.stream(pts))
    return fps_idx, knn_idx
