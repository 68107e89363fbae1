"""Batched augmentations on (B, N, 3) tensors (port of
``point_dae_tpu/data/transforms.py``; reference: datasets/data_transforms.py:
6-117, the 'GPU transforms').

Each function draws its randomness from the given ``torch.Generator`` on
the points' device. No run path calls them (the fine-tune steps draw their
own augmentations, ``engine/finetune.py``); they keep the module's API.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

Generator = Optional[torch.Generator]


def _uniform(shape, lo: float, hi: float, like: torch.Tensor, generator: Generator):
    u = torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    return lo + (hi - lo) * u


def pointcloud_scale_and_translate(pts: torch.Tensor, generator: Generator = None,
                                   scale_low: float = 2. / 3., scale_high: float = 3. / 2.,
                                   translate_range: float = 0.2) -> torch.Tensor:
    """PointcloudScaleAndTranslate (data_transforms.py:6-20)."""
    B = pts.shape[0]
    s = _uniform((B, 1, 3), scale_low, scale_high, pts, generator)
    t = _uniform((B, 1, 3), -translate_range, translate_range, pts, generator)
    return pts * s + t


def pointcloud_scale(pts: torch.Tensor, generator: Generator = None,
                     lo: float = 2. / 3., hi: float = 3. / 2.) -> torch.Tensor:
    return pts * _uniform((pts.shape[0], 1, 3), lo, hi, pts, generator)


def pointcloud_translate(pts: torch.Tensor, generator: Generator = None,
                         translate_range: float = 0.2) -> torch.Tensor:
    return pts + _uniform((pts.shape[0], 1, 3), -translate_range, translate_range,
                          pts, generator)


def pointcloud_jitter(pts: torch.Tensor, generator: Generator = None, std: float = 0.01,
                      clip: float = 0.05) -> torch.Tensor:
    """PointcloudJitter: clipped gaussian noise."""
    noise = torch.randn(pts.shape, generator=generator, device=pts.device, dtype=pts.dtype)
    return pts + (std * noise).clamp(-clip, clip)


def pointcloud_rotate(pts: torch.Tensor, generator: Generator = None,
                      axis: Sequence[float] = (0.0, 1.0, 0.0)) -> torch.Tensor:
    """PointcloudRotate: per-sample rotation about a fixed axis (default y,
    the torch transform's convention), by Rodrigues' formula."""
    ang = _uniform((pts.shape[0],), 0.0, 2 * math.pi, pts, generator)
    u = torch.tensor(axis, dtype=pts.dtype, device=pts.device)
    u = u / torch.linalg.vector_norm(u)
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    ux, uy, uz = u
    z = torch.zeros((), dtype=pts.dtype, device=pts.device)
    cross = torch.stack([torch.stack([z, -uz, uy]), torch.stack([uz, z, -ux]),
                         torch.stack([-uy, ux, z])])
    outer = torch.outer(u, u)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    R = c * eye + s * cross + (1 - c) * outer                   # (B, 3, 3)
    return torch.einsum("bnd,bde->bne", pts, R)


def random_input_dropout(pts: torch.Tensor, generator: Generator = None,
                         max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """PointcloudRandomInputDropout: per-sample ratio ~ U(0, max); dropped
    points are replaced by the first point (the torch transform's trick)."""
    B, N, _ = pts.shape
    ratio = _uniform((B, 1), 0.0, max_dropout_ratio, pts, generator)
    drop = _uniform((B, N), 0.0, 1.0, pts, generator) <= ratio
    return torch.where(drop[..., None], pts[:, :1, :], pts)


def random_horizontal_flip(pts: torch.Tensor, generator: Generator = None,
                           upright_axis: int = 2) -> torch.Tensor:
    """PointcloudRandomHorizontalFlip: flip each non-up axis w.p. 0.5
    (aligned-data convention)."""
    flips = _uniform((pts.shape[0], 3), 0.0, 1.0, pts, generator) < 0.5
    flips[:, upright_axis] = False
    sign = torch.where(flips, -1.0, 1.0).to(pts.dtype)
    return pts * sign[:, None, :]
