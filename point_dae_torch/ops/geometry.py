"""Fixed-shape point-cloud geometry (port of
``point_dae_tpu/ops/geometry.py:29-334``): FPS, kNN, gathers, the ball
query of the set abstractions, the patchify front end of the patch
models, the batched resample and the 3-NN feature interpolation of the
part-segmentation head.

On a CUDA tensor at training shapes ``fps_knn`` runs the fused patchify
kernel (``ops/patchify.py``); otherwise it composes FPS with a kNN over the
matrix-expansion distances, as the JAX package does off the TPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import fps
from .gather import gather_by_mask, gather_rows, ranks_from_uniforms
from .tiled_knn import knn_kernel
from .patchify import fused_patchify


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """||x||^2 - 2 x.y^T + ||y||^2, clamped at 0, in f32.
    x: (..., N, D), y: (..., M, D) -> (..., N, M)."""
    x = x.float()
    y = y.float()
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1, keepdim=True)
    d = xx - 2.0 * torch.matmul(x, y.transpose(-1, -2)) + yy.transpose(-1, -2)
    return d.clamp_min(0.0)


def use_knn_kernel(device_type: str, n_query: int, n_db: int, k: int) -> bool:
    """The ``knn_pallas`` gate of ``geometry.py:59-61`` with "on TPU" read
    as "on CUDA"."""
    return (device_type == "cuda" and 512 <= n_db <= 1024 and n_db % 128 == 0
            and n_query % 8 == 0 and 8 <= k <= 64)


def knn(query: torch.Tensor, database: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest database points of each query point, ascending by distance,
    lower index first on ties (a stable sort, as ``jax.lax.top_k`` orders
    them). query (B, M, D), database (B, N, D) -> (dists, idx int32).
    Inside the ``knn_pallas`` gate on CUDA the kNN kernel runs (unclamped
    distances, no gradient, ``ops/tiled_knn.py``); elsewhere the clamped
    matrix-expansion distances are sorted, as the JAX package does off the
    TPU."""
    if use_knn_kernel(query.device.type, query.shape[1], database.shape[1], k):
        return knn_kernel(query, database, k)
    d = pairwise_sqdist(query, database)
    srt = torch.sort(d, dim=-1, stable=True)
    return srt.values[..., :k], srt.indices[..., :k].int()


def furthest_point_sample(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, N, 3) -> (B, n_samples) int32. First pick is index 0; points with
    |p|^2 <= 1e-3 are never picked. On a CUDA tensor inside the JAX FPS gates
    the ``fps`` kernel runs (``ops/fps.py``); elsewhere its plain version."""
    return fps.furthest_point_sample(points, n_samples)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    C = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, C))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, K) -> (B, M, K, C), through
    ``gather_rows`` (the small-C kernel at training shapes)."""
    B, N, C = points.shape
    M, K = idx.shape[1], idx.shape[2]
    return gather_rows(points, idx.reshape(B, M * K)).reshape(B, M, K, C)


def ball_query(radius: float, k: int, xyz: torch.Tensor, new_xyz: torch.Tensor
               ) -> torch.Tensor:
    """For each query centre, the indices of up to k points within
    ``radius`` (JAX ``geometry.py:171-195``, pointnet2's
    ``query_ball_point`` semantics): points taken in index order; when
    fewer than k qualify the remaining slots repeat the first in-range
    index, when none qualifies every slot is 0. In range means a squared
    distance (``pairwise_sqdist``'s rounding) strictly below radius^2 in
    f32. xyz (B, N, 3), new_xyz (B, M, 3) -> (B, M, min(k, N)) int32."""
    d = pairwise_sqdist(new_xyz, xyz)                       # (B, M, N)
    in_range = d < torch.tensor(radius * radius, dtype=torch.float32)
    N = xyz.shape[1]
    order = torch.arange(N, dtype=torch.int32, device=xyz.device)
    key = torch.where(in_range, order, order + N)
    first_k = torch.topk(key, min(k, N), dim=-1, largest=False, sorted=True).values
    cnt = in_range.sum(-1, dtype=torch.int32)               # (B, M)
    first = torch.where(cnt > 0, first_k[..., 0] % N, 0)
    slot = torch.arange(first_k.shape[-1], dtype=torch.int32, device=xyz.device)
    return torch.where(slot < cnt[..., None], first_k % N, first[..., None]).int()


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest known points of each unknown point: unknown (B, N, 3),
    known (B, M, 3) -> (squared dist (B, N, 3), idx (B, N, 3) int32)."""
    return knn(unknown, known, 3)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance-weighted interpolation: features (B, M, C), idx and
    squared dist (B, N, 3) -> (B, N, C). The gather goes through
    ``group_points``, so its backward is the row scatter-add (the kernel
    inside its gate on CUDA)."""
    w = 1.0 / (dist + eps)
    w = w / w.sum(-1, keepdim=True)
    neigh = group_points(features, idx)                     # (B, N, 3, C)
    return (neigh * w[..., None]).sum(2)


def use_fused_patchify(xyz: torch.Tensor, num_group: int, group_size: int) -> bool:
    """``geometry.py:238-241`` with "on TPU" read as "on CUDA"."""
    N = xyz.shape[1]
    return (xyz.device.type == "cuda" and N >= 512 and N % 128 == 0
            and num_group % 8 == 0 and group_size >= 8
            and num_group * N * 4 <= 8 * 2 ** 20)


def fps_knn(xyz: torch.Tensor, num_group: int, group_size: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS centres + kNN patch membership.
    xyz (B, N, 3) -> (fps_idx (B, G) int32, center (B, G, 3),
    idx (B, G, S) int32 ascending by distance)."""
    if use_fused_patchify(xyz, num_group, group_size):
        fps_idx, idx = fused_patchify(xyz, num_group, group_size)
        return fps_idx, gather_points(xyz, fps_idx), idx
    fps_idx = furthest_point_sample(xyz, num_group)
    center = gather_points(xyz, fps_idx)
    _, idx = knn(center, xyz, group_size)
    return fps_idx, center, idx


def group_neighborhood(xyz: torch.Tensor, num_group: int, group_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS + kNN patchify: xyz (B, N, 3) -> (neighborhood (B, G, S, 3)
    centred on its patch centre, center (B, G, 3))."""
    _, center, idx = fps_knn(xyz, num_group, group_size)
    neighborhood = group_points(xyz, idx) - center[:, :, None, :]
    return neighborhood, center


def use_key_gather_kernel(points: torch.Tensor, num: int) -> bool:
    """The rank-keyed gather gate of ``geometry.py:325-327`` with "on TPU"
    read as "on CUDA"."""
    B, N, C = points.shape
    return (points.device.type == "cuda" and C <= 8 and N <= 2048
            and N % min(N, 2048) == 0 and points.dtype == torch.float32
            and B * num >= 2 ** 16)


def resample_batch(points: torch.Tensor, mask: Optional[torch.Tensor], num: int,
                   draws: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform draws with replacement from each row's valid subset.
    points (B, N, C), mask (B, N) bool or None -> (B, num, C). ``draws``
    (B, num) are integer ranks into the valid subset (below the row's valid
    count, which is at least 1), or uniforms in [0, 1) that become the ranks
    floor(u * count); sampled from ``generator`` when not given. Rank q is
    the q-th valid point in its original order: inside the JAX gate on CUDA
    the key gather kernel selects it from the mask and the draws in one
    launch (a row with no valid point gives zeros there), elsewhere a stable
    sort packs the valid points to the front (such a row gives
    ``points[0]``), as in the JAX package."""
    B, N, C = points.shape
    if mask is None:
        if draws is None:
            draws = torch.randint(0, N, (B, num), generator=generator,
                                  device=points.device)
        return gather_rows(points, draws)
    if draws is None:
        draws = torch.rand((B, num), generator=generator, device=points.device)
    if use_key_gather_kernel(points, num):
        return gather_by_mask(points, mask, draws)
    if draws.is_floating_point():
        draws = ranks_from_uniforms(mask, draws)
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    pos = torch.gather(order, 1, draws.long())
    return torch.gather(points, 1, pos[..., None].expand(-1, -1, C))
