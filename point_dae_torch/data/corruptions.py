"""Whole-cloud augmentation and corruption (port of the parts of
``point_dae_tpu/data/corruptions.py`` that the ported pretrain configs
reach: ``aug_type: [norm]`` and ``corrupt_type`` among ``clean``,
``affine_r3`` and ``dropout_local``), batched over the clouds.

Every random draw is a field of a draws dataclass, sampled from a
``torch.Generator`` when the caller does not supply it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .corruptions_patch import AFFINE_NAMES, _batched_rot, _uniform

MAX_CLUSTERS = 8     # dropout_local removes 1 .. MAX_CLUSTERS - 1 clusters


def pc_normalize(pc: torch.Tensor) -> torch.Tensor:
    """Centre each cloud and scale it into the unit sphere. pc: (B, N, 3)."""
    pc = pc - pc.mean(dim=1, keepdim=True)
    m = torch.sqrt((pc ** 2).sum(-1)).amax(dim=1)
    return pc / m.clamp_min(1e-12)[:, None, None]


def augment_batch(pts: torch.Tensor, types: Sequence[str]) -> torch.Tensor:
    """``augment_cloud`` over a batch: 'norm' and 'clean' are ported."""
    for t in types:
        if t == "norm":
            pts = pc_normalize(pts)
        elif t != "clean":
            raise NotImplementedError(f"augmentation {t!r} is not ported yet")
    return pts


@dataclass
class CloudAffineDraws:
    """The draws of one cloud-level 'affine_r3' / 'affine_r5' composite,
    per cloud: how many of the five families apply, in which order, each
    family's severity level (U{0..4}; none of the five default families
    reads it) and each family's parameters."""
    count: torch.Tensor       # (B,) int, 1 .. max_n
    perm: torch.Tensor        # (B, 5) int, a permutation of AFFINE_NAMES indices
    levels: torch.Tensor      # (B, 5)
    translate: torch.Tensor   # (B, 3) in (-0.5, 0.5), added
    scale: torch.Tensor       # (B, 3) in (0.5, 2)
    angles: torch.Tensor      # (B, 3) Euler angles in (-pi, pi)
    reflect: torch.Tensor     # (B, 3) bool, True keeps the axis' sign
    shear: torch.Tensor       # (B, 6) in (-0.5, 0.5), off-diagonals row-major


@dataclass
class DropoutLocalDraws:
    """The draws of one 'dropout_local', per cloud of n points."""
    ratio: torch.Tensor         # (B,) in (0.1, 0.5): the share of points removed
    num_clusters: torch.Tensor  # (B,) int, 1 .. MAX_CLUSTERS - 1
    picks: torch.Tensor         # (B, n) int in [0, num_clusters): cluster of each removal
    seed_u: torch.Tensor        # (B, MAX_CLUSTERS - 1, n) uniforms choosing each cluster's seed point


@dataclass
class CloudCorruptDraws:
    affine: Optional[CloudAffineDraws] = None
    dropout: Optional[DropoutLocalDraws] = None


def sample_cloud_affine(batch: int, max_n: int, generator: Optional[torch.Generator],
                        device) -> CloudAffineDraws:
    n = len(AFFINE_NAMES)
    return CloudAffineDraws(
        count=torch.randint(1, max_n + 1, (batch,), generator=generator, device=device),
        perm=torch.rand((batch, n), generator=generator, device=device).argsort(1),
        levels=torch.randint(0, 5, (batch, n), generator=generator, device=device).float(),
        translate=_uniform((batch, 3), -0.5, 0.5, generator, device),
        scale=_uniform((batch, 3), 0.5, 2.0, generator, device),
        angles=_uniform((batch, 3), -math.pi, math.pi, generator, device),
        reflect=torch.rand((batch, 3), generator=generator, device=device) < 0.5,
        shear=_uniform((batch, 6), -0.5, 0.5, generator, device))


def sample_dropout_local(batch: int, n: int, generator: Optional[torch.Generator],
                         device) -> DropoutLocalDraws:
    num_clusters = torch.randint(1, MAX_CLUSTERS, (batch,), generator=generator,
                                 device=device)
    u = torch.rand((batch, n), generator=generator, device=device)
    picks = (u * num_clusters[:, None]).long().clamp_max(num_clusters[:, None] - 1)
    return DropoutLocalDraws(
        ratio=_uniform((batch,), 0.1, 0.5, generator, device),
        num_clusters=num_clusters, picks=picks,
        seed_u=torch.rand((batch, MAX_CLUSTERS - 1, n), generator=generator,
                          device=device))


def compose_random_affines(draws: CloudAffineDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per cloud (A (B, 3, 3), b (B, 3)) of the first ``count`` families in
    the drawn order, composed in sequence: x -> x @ A + b."""
    B = draws.count.shape[0]
    dev = draws.translate.device
    eye = torch.eye(3, device=dev).expand(B, 3, 3)
    zeros = torch.zeros((B, 3), device=dev)
    s = draws.shear
    o = torch.ones(B, device=dev)
    shear = torch.stack([torch.stack([o, s[:, 0], s[:, 1]], -1),
                         torch.stack([s[:, 2], o, s[:, 3]], -1),
                         torch.stack([s[:, 4], s[:, 5], o], -1)], -2)
    signs = torch.where(draws.reflect, 1.0, -1.0)
    mats = torch.stack([eye, torch.diag_embed(draws.scale), _batched_rot(draws.angles),
                        torch.diag_embed(signs), shear], 1)           # (B, 5, 3, 3)
    vecs = torch.stack([draws.translate, zeros, zeros, zeros, zeros], 1)
    A, b = eye, zeros
    rows = torch.arange(B, device=dev)
    for slot in range(len(AFFINE_NAMES)):
        j = draws.perm[:, slot].long()
        use = slot < draws.count
        Ai = torch.where(use[:, None, None], mats[rows, j], eye)
        bi = torch.where(use[:, None], vecs[rows, j], zeros)
        A, b = A @ Ai, (b[:, None, :] @ Ai)[:, 0] + bi
    return A, b


def histogram_sizes(picks: torch.Tensor, total: torch.Tensor, max_clusters: int
                    ) -> torch.Tensor:
    """Per row, the histogram of the first ``total`` cluster picks over
    ``max_clusters`` bins. picks (B, n), total (B,) -> (B, max_clusters)."""
    live = torch.arange(picks.shape[1], device=picks.device)[None, :] < total[:, None]
    sizes = torch.zeros((picks.shape[0], max_clusters), dtype=torch.int64,
                        device=picks.device)
    return sizes.scatter_add_(1, picks.long(), live.long())


def k_smallest_mask(d: torch.Tensor, mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per row, the ``min(k, sum(mask))`` entries of ``d`` with the smallest
    values among the ``mask``-valid ones, ties broken by index order: a
    stable argsort and a rank test (the selection the JAX package makes
    without a sort). d (B, n) finite where valid, mask (B, n), k (B,)."""
    key = torch.where(mask, d, torch.full((), float("inf"), device=d.device))
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(d.shape[1], device=d.device).expand_as(order))
    return (rank < k[:, None]) & mask


def dropout_local(pts: torch.Tensor, mask: torch.Tensor, draws: DropoutLocalDraws
                  ) -> torch.Tensor:
    """Remove ``num_clusters`` clusters totalling ``ratio`` of each cloud's
    valid points: every cluster is the K nearest remaining points to a
    random remaining point. pts (B, n, 3), mask (B, n) -> the new mask."""
    n_valid = mask.sum(1)
    total = (n_valid.float() * draws.ratio).long()
    sizes = histogram_sizes(draws.picks, total, MAX_CLUSTERS - 1)
    for i in range(MAX_CLUSTERS - 1):
        r = torch.where(mask, draws.seed_u[:, i], -1.0)
        seed = torch.gather(pts, 1, r.argmax(1)[:, None, None].expand(-1, 1, 3))
        dif = pts - seed
        d = dif[..., 0] * dif[..., 0] + dif[..., 1] * dif[..., 1] + dif[..., 2] * dif[..., 2]
        mask = mask & ~k_smallest_mask(d, mask, sizes[:, i])
    return mask


def corrupt_batch(pts: torch.Tensor, types: Sequence[str],
                  draws: Optional[CloudCorruptDraws] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``corrupt_cloud`` over a batch: (points (B, n, 3), validity mask
    (B, n) or None when every point stays valid). Ported: 'clean' (and the
    in-model 'dropout_global*' / 'dropout_patch_pointmae', no-ops here),
    one 'affine_r3' and one 'dropout_local'."""
    types = tuple(types)
    for t in ("affine_r3", "dropout_local"):
        if types.count(t) > 1:
            raise NotImplementedError(f"more than one {t!r} in corrupt_type")
    B, n = pts.shape[:2]
    if draws is None:
        draws = CloudCorruptDraws(
            sample_cloud_affine(B, 3, generator, pts.device)
            if "affine_r3" in types else None,
            sample_dropout_local(B, n, generator, pts.device)
            if "dropout_local" in types else None)
    mask = None
    for t in types:
        if t in ("clean", "dropout_patch_pointmae") or t.startswith("dropout_global"):
            continue
        if t == "affine_r3":
            A, b = compose_random_affines(draws.affine)
            pts = pts @ A + b[:, None, :]
        elif t == "dropout_local":
            if mask is None:
                mask = torch.ones((B, n), dtype=torch.bool, device=pts.device)
            mask = dropout_local(pts, mask, draws.dropout)
        else:
            raise NotImplementedError(f"cloud corruption {t!r} is not ported yet")
    return pts, mask
