"""Whole-cloud augmentation and corruption (port of
``point_dae_tpu/data/corruptions.py``), batched over the clouds: every
family of ``corrupt_cloud`` and every augmentation of ``augment_cloud``.

Every random draw is a field of a draws dataclass (or, for a family with
one draw, a tensor), sampled from a ``torch.Generator`` when the caller
does not supply it. ``CloudCorruptDraws`` holds one entry per
``corrupt_type`` position with that position's severity level;
``augment_batch`` takes one tensor per ``aug_type`` position.

Adding families grow the buffer by n // 2 rows each (n the raw count);
the validity mask stays None unless a family that masks or adds points is
in the list, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .corruptions_patch import AFFINE_NAMES, _batched_rot, _uniform

AFFINE_NAMES_V2 = ("translate", "scale_nonorm", "rotate_level1", "reflection", "shear_1p")
MAX_CLUSTERS = 8     # dropout_local / add_local: 1 .. MAX_CLUSTERS - 1 clusters

# the composites: (how many of the names at most, the names)
_COMPOSITES = {"affine_r3": (3, AFFINE_NAMES), "affine_r5": (5, AFFINE_NAMES),
               "affine_r3_v2": (3, AFFINE_NAMES_V2), "affine_r5_v2": (5, AFFINE_NAMES_V2)}
# each single affine: (kind, its parameter's range); None = read from the level
_AFFINE = {
    "translate": ("translate", 0.5), "translate_tiny": ("translate", 0.1),
    "translate_middle": ("translate", 0.3), "translate_too_large": ("translate", 0.8),
    "scale_nonorm": ("scale", 2.0), "scale_nonorm_1p5": ("scale", 1.5),
    "scale_nonorm_4": ("scale", 4.0), "scale_nonorm_10": ("scale", 10.0),
    "rotate": ("euler", math.pi),
    **{f"rotate_level{k}": ("euler", math.pi / 5.0 * (k + 1.0)) for k in range(5)},
    "reflection": ("reflect", None),
    "shear": ("shear", 0.5), "shear_p5": ("shear", 0.5), "shear_p1": ("shear", 0.1),
    "shear_p3": ("shear", 0.3), "shear_p8": ("shear", 0.8), "shear_1p": ("shear", 1.0),
    "shear_2p": ("shear", 2.0), "shear_small": ("shear", None), "rotate_z": ("rotz", None),
}
_JITTER_P = {"jitter_p01": 0.01, "jitter_p03": 0.03, "jitter_p05": 0.05, "jitter_p1": 0.1}
_SCALE_SINGLE = (1.6, 1.7, 1.8, 1.9, 2.0)
_NOOP = ("clean", "dropout_patch_pointmae")
_MASKING = ("dropout_local", "add_global", "add_local", "nonuniform_density", "random_add")
_ADDING = ("add_global", "add_local", "random_add")


def pc_normalize(pc: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Centre each cloud and scale it into the unit sphere. pc (B, N, 3);
    with a validity ``mask`` (B, N) the mean and the largest norm come from
    the valid rows only."""
    if mask is None:
        pc = pc - pc.mean(dim=1, keepdim=True)
        m = torch.sqrt((pc ** 2).sum(-1)).amax(dim=1)
        return pc / m.clamp_min(1e-12)[:, None, None]
    w = mask.to(pc.dtype)[..., None]
    cnt = w.sum(1, keepdim=True).clamp_min(1.0)
    pc = pc - (pc * w).sum(1, keepdim=True) / cnt
    norms = torch.sqrt((pc ** 2).sum(-1))
    m = torch.where(mask, norms, 0.0).amax(dim=1)
    return pc / m.clamp_min(1e-12)[:, None, None]


def _sqnorm3(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis (3), in the JAX package's order."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# ----------------------------------------------------------------- affines

def _level_clip(kind: str, level: torch.Tensor) -> torch.Tensor:
    """rotate_z: pi (level + 1) / 5; shear_small: 0.02 (level + 1)."""
    return (math.pi / 5.0 if kind == "rotz" else 0.02) * (level + 1.0)


def sample_affine_param(name: str, level: torch.Tensor,
                        generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One single affine's parameter a cloud: translate (B, 3) added, scale
    (B, 3), Euler angles (B, 3), reflection (B, 3) bool (True keeps the
    axis), shear (B, 6) off-diagonals row-major, rotate_z (B,) angle."""
    kind, s = _AFFINE[name]
    B = level.shape[0]
    if kind == "translate":
        return _uniform((B, 3), -s, s, generator, device)
    if kind == "scale":
        return _uniform((B, 3), 1.0 / s, s, generator, device)
    if kind == "euler":
        return _uniform((B, 3), -s, s, generator, device)
    if kind == "reflect":
        return torch.rand((B, 3), generator=generator, device=device) < 0.5
    shape = (B, 6) if kind == "shear" else (B,)
    u = torch.rand(shape, generator=generator, device=device)
    if s is not None:
        return u * (2 * s) - s
    clip = _level_clip(kind, level).reshape((B,) + (1,) * (len(shape) - 1))
    return u * (2 * clip) - clip


def shear_matrix(s: torch.Tensor) -> torch.Tensor:
    """(B, 6) off-diagonals, row-major -> (B, 3, 3) with a unit diagonal."""
    o = torch.ones_like(s[:, 0])
    return torch.stack([torch.stack([o, s[:, 0], s[:, 1]], -1),
                        torch.stack([s[:, 2], o, s[:, 3]], -1),
                        torch.stack([s[:, 4], s[:, 5], o], -1)], -2)


def rotz_matrix(ang: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 3, 3) z rotations for x @ R."""
    c, s = torch.cos(ang), torch.sin(ang)
    o, z = torch.ones_like(ang), torch.zeros_like(ang)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def affine_from_param(name: str, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A (B, 3, 3), b (B, 3)) of one single affine, applied as x @ A + b."""
    kind = _AFFINE[name][0]
    B = p.shape[0]
    zeros = torch.zeros((B, 3), device=p.device)
    if kind == "translate":
        return torch.eye(3, device=p.device).expand(B, 3, 3), p
    if kind == "scale":
        return torch.diag_embed(p), zeros
    if kind == "euler":
        return _batched_rot(p), zeros
    if kind == "reflect":
        return torch.diag_embed(torch.where(p, 1.0, -1.0)), zeros
    if kind == "shear":
        return shear_matrix(p), zeros
    return rotz_matrix(p), zeros


@dataclass
class CloudAffineDraws:
    """The draws of one composite ('affine_r3', 'affine_r5' and their _v2
    forms), per cloud: how many of the names apply, in which order, each
    name's severity level (U{0..4}; none of the composites' names reads it)
    and each name's parameters (``sample_affine_param``)."""
    count: torch.Tensor       # (B,) int, 1 .. max_n
    perm: torch.Tensor        # (B, len(names)) int, a permutation of name indices
    levels: torch.Tensor      # (B, len(names))
    params: Tuple[torch.Tensor, ...]   # one per name


def sample_cloud_affine(batch: int, max_n: int, names: Sequence[str],
                        generator: Optional[torch.Generator], device) -> CloudAffineDraws:
    n = len(names)
    levels = torch.randint(0, 5, (batch, n), generator=generator, device=device).float()
    return CloudAffineDraws(
        count=torch.randint(1, max_n + 1, (batch,), generator=generator, device=device),
        perm=torch.rand((batch, n), generator=generator, device=device).argsort(1),
        levels=levels,
        params=tuple(sample_affine_param(nm, levels[:, i], generator, device)
                     for i, nm in enumerate(names)))


def compose_random_affines(draws: CloudAffineDraws, names: Sequence[str] = AFFINE_NAMES
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per cloud (A (B, 3, 3), b (B, 3)) of the first ``count`` names in the
    drawn order, composed in sequence: x -> x @ A + b."""
    B = draws.count.shape[0]
    dev = draws.params[0].device
    eye = torch.eye(3, device=dev).expand(B, 3, 3)
    zeros = torch.zeros((B, 3), device=dev)
    pairs = [affine_from_param(nm, p) for nm, p in zip(names, draws.params)]
    mats = torch.stack([a for a, _ in pairs], 1)                    # (B, n, 3, 3)
    vecs = torch.stack([b for _, b in pairs], 1)                    # (B, n, 3)
    A, b = eye, zeros
    rows = torch.arange(B, device=dev)
    for slot in range(len(names)):
        j = draws.perm[:, slot].long()
        use = slot < draws.count
        Ai = torch.where(use[:, None, None], mats[rows, j], eye)
        bi = torch.where(use[:, None], vecs[rows, j], zeros)
        A, b = A @ Ai, (b[:, None, :] @ Ai)[:, 0] + bi
    return A, b


# ----------------------------------------------------------------- clusters

def histogram_sizes(picks: torch.Tensor, total: torch.Tensor, max_clusters: int
                    ) -> torch.Tensor:
    """Per row, the histogram of the first ``total`` cluster picks over
    ``max_clusters`` bins. picks (B, n), total (B,) -> (B, max_clusters)."""
    live = torch.arange(picks.shape[1], device=picks.device)[None, :] < total[:, None]
    sizes = torch.zeros((picks.shape[0], max_clusters), dtype=torch.int64,
                        device=picks.device)
    return sizes.scatter_add_(1, picks.long(), live.long())


def _sample_picks(num_clusters: torch.Tensor, n: int,
                  generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(B, n) uniform cluster picks in [0, num_clusters) a row."""
    u = torch.rand((num_clusters.shape[0], n), generator=generator, device=device)
    return (u * num_clusters[:, None]).long().clamp_max(num_clusters[:, None] - 1)


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


@dataclass
class DropoutLocalDraws:
    """The draws of one 'dropout_local*', per cloud of n rows; the number of
    clusters is at most ``max_clusters - 1``."""
    ratio: torch.Tensor         # (B,) the share of valid points removed
    num_clusters: torch.Tensor  # (B,) int, 1 .. max_clusters - 1
    picks: torch.Tensor         # (B, n) int in [0, num_clusters): cluster of each removal
    seed_u: torch.Tensor        # (B, max_clusters - 1, n) uniforms choosing each cluster's seed


def sample_dropout_local(batch: int, n: int, generator: Optional[torch.Generator],
                         device, max_clusters: int = MAX_CLUSTERS,
                         drop_ratio: Optional[float] = None) -> DropoutLocalDraws:
    """The ratio ~ U(0.1, 0.5) unless ``drop_ratio`` pins it."""
    num_clusters = torch.randint(1, max_clusters, (batch,), generator=generator,
                                 device=device)
    ratio = _uniform((batch,), 0.1, 0.5, generator, device) if drop_ratio is None \
        else torch.full((batch,), drop_ratio, device=device)
    return DropoutLocalDraws(
        ratio=ratio, num_clusters=num_clusters,
        picks=_sample_picks(num_clusters, n, generator, device),
        seed_u=torch.rand((batch, max_clusters - 1, n), generator=generator,
                          device=device))


def dropout_local(pts: torch.Tensor, mask: torch.Tensor, draws: DropoutLocalDraws,
                  max_clusters: int = MAX_CLUSTERS) -> torch.Tensor:
    """Remove ``num_clusters`` clusters totalling ``ratio`` of each cloud's
    valid points: every cluster is the K nearest remaining points to a
    random remaining point. pts (B, n, 3), mask (B, n) -> the new mask."""
    n_valid = mask.sum(1)
    total = (n_valid.float() * draws.ratio).long()
    sizes = histogram_sizes(draws.picks, total, max_clusters - 1)
    for i in range(max_clusters - 1):
        r = torch.where(mask, draws.seed_u[:, i], -1.0)
        seed = torch.gather(pts, 1, r.argmax(1)[:, None, None].expand(-1, 1, 3))
        d = _sqnorm3(pts - seed)
        mask = mask & ~k_smallest_mask(d, mask, sizes[:, i])
    return mask


def _dropout_local_spec(t: str) -> Tuple[int, Optional[float]]:
    """(max_clusters, pinned ratio) of 'dropout_local' / 'dropout_local_cXdY'.
    The reference draws the count with an exclusive high, so cX never draws
    X clusters and c1 means one: max(X, 2) keeps both quirks."""
    if t == "dropout_local":
        return MAX_CLUSTERS, None
    c, d = t[len("dropout_local_c"):].split("d")
    return max(int(c), 2), int(d) / 10.0


# ----------------------------------------------------------------- adding

def _add_count(mask: torch.Tensor, level: torch.Tensor, extra: int) -> torch.Tensor:
    """int(n_valid (level + 1) 0.1), at most ``extra``: the points added."""
    n_valid = mask.sum(1)
    return (n_valid.float() * (level + 1.0) * 0.1).long().clamp_max(extra)


def ball_from_draws(u: torch.Tensor) -> torch.Tensor:
    """Points in the unit ball from (..., 3) draws (radius uniform in [0, 1),
    cos(theta) in [-1, 1), phi in [0, 2 pi)): radius = u^(1/3)."""
    radius = u[..., 0:1] ** (1.0 / 3.0)
    cost, phi = u[..., 1:2], u[..., 2:3]
    sint = torch.sqrt((1.0 - cost ** 2).clamp_min(0.0))
    return torch.cat([radius * sint * torch.cos(phi), radius * sint * torch.sin(phi),
                      radius * cost], -1)


def sample_ball_draws(batch: int, extra: int, generator: Optional[torch.Generator],
                      device) -> torch.Tensor:
    u = torch.rand((batch, extra, 3), generator=generator, device=device)
    return u * torch.tensor([1.0, 2.0, 2 * math.pi], device=device) \
        - torch.tensor([0.0, 1.0, 0.0], device=device)


def add_global(pts: torch.Tensor, mask: torch.Tensor, level: torch.Tensor,
               ball: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append int(n_valid (level + 1) 0.1) uniform points of the unit ball
    (at most ``extra``): the buffer grows by ``extra`` = ball.shape[1] rows,
    valid up to the count. ball: the (B, extra, 3) ``ball_from_draws`` draws."""
    extra = ball.shape[1]
    n_add = _add_count(mask, level, extra)
    tail = torch.arange(extra, device=pts.device)[None, :] < n_add[:, None]
    return torch.cat([pts, ball_from_draws(ball)], 1), torch.cat([mask, tail], 1)


def cluster_slots(sizes: torch.Tensor, extra: int) -> torch.Tensor:
    """The cluster of each of ``extra`` contiguous append slots given the
    per-cluster sizes (B, C) -> (B, extra)."""
    cum = torch.cumsum(sizes, 1)
    slot = torch.arange(extra, device=sizes.device)
    return (slot[None, :, None] >= cum[:, None, :]).sum(-1)


def sphere_pullback(p: torch.Tensor) -> torch.Tensor:
    """Rows outside the unit sphere divided by their squared norm (the
    reference's formula)."""
    d2 = _sqnorm3(p)[..., None]
    return torch.where(d2 > 1.0, p / d2, p)


@dataclass
class AddLocalDraws:
    """The draws of one 'add_local', per cloud of n rows growing by extra."""
    num_clusters: torch.Tensor  # (B,) int, 1 .. MAX_CLUSTERS - 1
    picks: torch.Tensor         # (B, extra) int in [0, num_clusters)
    anchor_u: torch.Tensor      # (B, n) uniforms choosing the anchors
    sigma: torch.Tensor         # (B, MAX_CLUSTERS - 1) in (0.075, 0.125), one a cluster
    noise: torch.Tensor         # (B, extra, 3) standard normal


def sample_add_local(batch: int, n: int, extra: int, generator: Optional[torch.Generator],
                     device) -> AddLocalDraws:
    nc = torch.randint(1, MAX_CLUSTERS, (batch,), generator=generator, device=device)
    return AddLocalDraws(
        num_clusters=nc, picks=_sample_picks(nc, extra, generator, device),
        anchor_u=torch.rand((batch, n), generator=generator, device=device),
        sigma=_uniform((batch, MAX_CLUSTERS - 1), 0.075, 0.125, generator, device),
        noise=torch.randn((batch, extra, 3), generator=generator, device=device))


def add_local(pts: torch.Tensor, mask: torch.Tensor, level: torch.Tensor,
              draws: AddLocalDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian blobs (one sigma a cluster) around random valid points,
    int(n_valid (level + 1) 0.1) points in all (at most ``extra``) split
    over the drawn clusters; blob points outside the unit sphere are pulled
    back. The anchors are the rows of the 7 largest draws among the valid
    rows (a stable sort; invalid rows come after, by index)."""
    extra = draws.noise.shape[1]
    total = _add_count(mask, level, extra)
    sizes = histogram_sizes(draws.picks, total, MAX_CLUSTERS - 1)
    ci = cluster_slots(sizes, extra).clamp(0, MAX_CLUSTERS - 2)     # (B, extra)
    r = torch.where(mask, draws.anchor_u, -1.0)
    order = torch.sort(-r, dim=1, stable=True).indices[:, :MAX_CLUSTERS - 1]
    anchors = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    sig = torch.gather(draws.sigma, 1, ci)
    near = torch.gather(anchors, 1, ci[..., None].expand(-1, -1, 3))
    new = sphere_pullback(near + sig[..., None] * draws.noise)
    tail = torch.arange(extra, device=pts.device)[None, :] < total[:, None]
    return torch.cat([pts, new], 1), torch.cat([mask, tail], 1)


@dataclass
class RandomAddDraws:
    """'random_add': both adding families drawn, then a coin (True takes
    add_global)."""
    coin: torch.Tensor           # (B,) bool
    ball: torch.Tensor           # add_global's (B, extra, 3) draws
    local: AddLocalDraws


@dataclass
class DensityDraws:
    """'nonuniform_density': a view direction (normalised in the function)
    and one uniform a row."""
    view: torch.Tensor           # (B, 3) standard normal
    r: torch.Tensor              # (B, n) uniforms


def nonuniform_density(pts: torch.Tensor, mask: torch.Tensor, level: torch.Tensor,
                       draws: DensityDraws) -> torch.Tensor:
    """Drop points far from a random viewpoint on the unit sphere with a
    higher probability: keep where |p - v| / 2 * (level / 4 + 0.1) < r."""
    gate = level / 4.0 + 0.1
    v = draws.view
    v = v / torch.sqrt(_sqnorm3(v)).clamp_min(1e-12)[:, None]
    dist = torch.sqrt(_sqnorm3(pts - v[:, None, :])) / 2.0
    return mask & (dist * gate[:, None] < draws.r)


# ----------------------------------------------------------------- augmentation

_ROTATE_Z_CLIP = math.pi / 5.0 * (4.0 + 1.0)
# each aug_type: (its draw a cloud (batch, generator, device) or None, its apply)
_AUGMENTS = {
    "norm": (None, lambda pts, d: pc_normalize(pts)),
    "clean": (None, lambda pts, d: pts),
    "translate": (lambda B, g, dev: _uniform((B, 3), -0.2, 0.2, g, dev),
                  lambda pts, d: pts + d[:, None, :]),
    "scale": (lambda B, g, dev: _uniform((B, 3), 2.0 / 3.0, 3.0 / 2.0, g, dev),
              lambda pts, d: pts * d[:, None, :]),
    "rotate_z": (lambda B, g, dev: _uniform((B,), -_ROTATE_Z_CLIP, _ROTATE_Z_CLIP, g, dev),
                 lambda pts, d: pts @ rotz_matrix(d)),
    "rotate": (lambda B, g, dev: _uniform((B, 3), -math.pi, math.pi, g, dev),
               lambda pts, d: pts @ _batched_rot(d)),
}


def _augment(t: str):
    if t not in _AUGMENTS:
        raise NotImplementedError(f"augmentation {t!r}")
    return _AUGMENTS[t]


def sample_augment_draws(types: Sequence[str], batch: int,
                         generator: Optional[torch.Generator], device) -> List:
    """One entry per ``aug_type`` position: translate (B, 3), scale (B, 3),
    rotate_z (B,) angle, rotate (B, 3) Euler angles; None for norm, clean."""
    out = []
    for t in types:
        sample = _augment(t)[0]
        out.append(None if sample is None else sample(batch, generator, device))
    return out


def augment_batch(pts: torch.Tensor, types: Sequence[str], draws: Optional[List] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``augment_cloud`` over a batch: norm, clean, translate, scale,
    rotate_z and rotate, each drawn a cloud (``sample_augment_draws``)."""
    applies = [_augment(t)[1] for t in types]
    if draws is None:
        draws = sample_augment_draws(types, pts.shape[0], generator, pts.device)
    for apply, d in zip(applies, draws):
        pts = apply(pts, d)
    return pts


# ----------------------------------------------------------------- levels

def sample_rotation(mode: str, batch: int, generator: Optional[torch.Generator],
                    device) -> Optional[torch.Tensor]:
    """The angles of a ``rotation`` mode: ``z`` (B,) in +-pi (affine_rotate_z
    at level 4), ``so3`` (B, 3) Euler angles in +-pi (affine_rotate; R = Rz
    Ry Rx of independent uniform angles, not Haar-uniform), ``none`` None."""
    if mode == "z":
        return _uniform((batch,), -_ROTATE_Z_CLIP, _ROTATE_Z_CLIP, generator, device)
    if mode == "so3":
        return _uniform((batch, 3), -math.pi, math.pi, generator, device)
    if mode == "none":
        return None
    raise ValueError(f"rotation mode {mode!r}")


def rotation_matrix(mode: str, angles: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) f32 rotations for x @ R from ``sample_rotation``'s angles
    (any mode but ``z`` reads (B, 3) Euler angles, as the level rotations'
    are too), built in float64 and rounded once: the same bits on every device, where
    f32 sines and products differ in their last place between the card's
    and the CPU's libraries."""
    a = angles.double()
    return (rotz_matrix(a) if mode == "z" else _batched_rot(a)).float()


def rotate_points(pts: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """x @ R for (B, N, 3) clouds and (B, 3, 3) matrices as three rounded
    products summed left to right: the same bits on every device, where a
    matrix product's rounding depends on its kernel (and an FPS that
    follows would part on a near-tie)."""
    return (pts[..., 0:1] * R[:, None, 0] + pts[..., 1:2] * R[:, None, 1]
            + pts[..., 2:3] * R[:, None, 2])


def corrupt_jitter(pts: torch.Tensor, level: float, noise: torch.Tensor) -> torch.Tensor:
    """Gaussian jitter of sigma 0.01 (level + 1): noise (B, n, 3) standard
    normal."""
    return pts + 0.01 * (level + 1.0) * noise


def dropout_global_mask(mask: torch.Tensor, r: torch.Tensor, drop_rate: float) -> torch.Tensor:
    """Keep, of each row's valid points, the int(n_valid (1 - drop_rate))
    (counted in f32) with the smallest uniforms ``r`` (B, n)."""
    keep = (mask.sum(1).float() * (1.0 - drop_rate)).long()
    return k_smallest_mask(r, mask, keep)


# ----------------------------------------------------------------- dispatch

@dataclass
class CloudCorruptDraws:
    """The draws of ``corrupt_batch``: each position's severity level
    (U{0..4}, drawn for every position as the JAX package does) and each
    position's family draws (None for a no-op)."""
    levels: torch.Tensor         # (B, len(types))
    ops: List


def masks_points(types: Sequence[str]) -> bool:
    """Whether ``corrupt_batch`` returns a validity mask for ``types``."""
    return any(t.startswith(m) for t in types for m in _MASKING)


def corruption_capacity(n: int, types: Sequence[str]) -> int:
    """Buffer rows so that adding families never overflow: n // 2 each."""
    return n + sum(t in _ADDING for t in types) * (n // 2)


@dataclass(frozen=True)
class _Family:
    """One ``corrupt_type`` name: ``sample(batch, n raw rows, rows so far,
    level (B,), generator, device)`` draws it, ``apply(points, mask, level,
    draws)`` returns (points, mask)."""
    sample: Callable
    apply: Callable


# each family's draw (batch, n raw rows, rows so far, level, generator,
# device) and apply (points, mask, level, draws) -> (points, mask)

def _scale_draw(B, n, rows, lv, g, dev):
    return _uniform((B, 3), 0.5, 2.0, g, dev)


def _scale(pts, mask, lv, d):
    return pc_normalize(pts @ torch.diag_embed(d), mask), mask


def _scale_single_draw(B, n, rows, lv, g, dev):
    sv = torch.tensor(_SCALE_SINGLE, device=dev)[lv.long().to(dev)]
    return torch.rand((B, 1), generator=g, device=dev) * (sv - 1.0 / sv)[:, None] \
        + (1.0 / sv)[:, None]


def _scale_single(pts, mask, lv, d):
    return pc_normalize(pts * d[:, None, :], mask), mask


def _jitter_draw(B, n, rows, lv, g, dev):
    return torch.randn((B, rows, 3), generator=g, device=dev)


def _jitter(pts, mask, lv, d):
    return pts + (0.01 * (lv + 1.0))[:, None, None] * d, mask


def _add_global_draw(B, n, rows, lv, g, dev):
    return sample_ball_draws(B, n // 2, g, dev)


def _add_local_draw(B, n, rows, lv, g, dev):
    return sample_add_local(B, rows, n // 2, g, dev)


def _random_add_draw(B, n, rows, lv, g, dev):
    return RandomAddDraws(torch.rand((B,), generator=g, device=dev) > 0.5,
                          sample_ball_draws(B, n // 2, g, dev),
                          sample_add_local(B, rows, n // 2, g, dev))


def _random_add(pts, mask, lv, d):
    pg, mg = add_global(pts, mask, lv, d.ball)
    pl, ml = add_local(pts, mask, lv, d.local)
    return torch.where(d.coin[:, None, None], pg, pl), torch.where(d.coin[:, None], mg, ml)


def _density_draw(B, n, rows, lv, g, dev):
    return DensityDraws(torch.randn((B, 3), generator=g, device=dev),
                        torch.rand((B, rows), generator=g, device=dev))


def _density(pts, mask, lv, d):
    return pts, nonuniform_density(pts, mask, lv, d)


_FAMILIES = {
    "scale": _Family(_scale_draw, _scale),
    "scale_single": _Family(_scale_single_draw, _scale_single),
    "jitter": _Family(_jitter_draw, _jitter),
    "add_global": _Family(_add_global_draw, add_global),
    "add_local": _Family(_add_local_draw, add_local),
    "random_add": _Family(_random_add_draw, _random_add),
    "nonuniform_density": _Family(_density_draw, _density),
}


def _family(t: str) -> Optional[_Family]:
    """The family of one ``corrupt_type`` name, None for a no-op ('clean',
    'dropout_patch_pointmae' and 'dropout_global*': the in-model dropouts);
    raises NotImplementedError on a name ``corrupt_cloud`` does not
    dispatch. Every name is resolved here and nowhere else."""
    if t in _NOOP or t.startswith("dropout_global"):
        return None
    if t in _COMPOSITES:
        max_n, names = _COMPOSITES[t]

        def composite(pts, mask, lv, d):
            A, b = compose_random_affines(d, names)
            return pts @ A + b[:, None, :], mask

        return _Family(lambda B, n, rows, lv, g, dev: sample_cloud_affine(B, max_n, names, g,
                                                                          dev), composite)
    if t in _AFFINE:
        def single(pts, mask, lv, d):
            A, b = affine_from_param(t, d)
            return pts @ A + b[:, None, :], mask

        return _Family(lambda B, n, rows, lv, g, dev: sample_affine_param(t, lv, g, dev),
                       single)
    if t in _JITTER_P:
        return _Family(_jitter_draw, lambda pts, mask, lv, d: (pts + _JITTER_P[t] * d, mask))
    if t == "dropout_local" or t.startswith("dropout_local_c"):
        c, ratio = _dropout_local_spec(t)
        return _Family(lambda B, n, rows, lv, g, dev: sample_dropout_local(B, rows, g, dev, c,
                                                                           ratio),
                       lambda pts, mask, lv, d: (pts, dropout_local(pts, mask, d, c)))
    if t not in _FAMILIES:
        raise NotImplementedError(f"corruption {t!r}")
    return _FAMILIES[t]


def sample_corrupt_draws(types: Sequence[str], batch: int, n: int,
                         generator: Optional[torch.Generator], device
                         ) -> CloudCorruptDraws:
    """Draw every position of ``types`` for a batch of n-row clouds; raises
    NotImplementedError on a name ``corrupt_cloud`` does not dispatch."""
    families = [_family(t) for t in types]
    levels = torch.randint(0, 5, (batch, len(types)), generator=generator,
                           device=device).float()
    ops, rows = [], n
    for i, (t, fam) in enumerate(zip(types, families)):
        ops.append(None if fam is None
                   else fam.sample(batch, n, rows, levels[:, i], generator, device))
        if t in _ADDING:
            rows += n // 2
    return CloudCorruptDraws(levels, ops)


def corrupt_batch(pts: torch.Tensor, types: Sequence[str],
                  draws: Optional[CloudCorruptDraws] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``corrupt_cloud`` over a batch: (points (B, capacity, 3), validity
    mask (B, capacity), or None when no family of ``types`` masks or adds
    points)."""
    types = tuple(types)
    families = [_family(t) for t in types]
    B, n = pts.shape[:2]
    if draws is None:
        draws = sample_corrupt_draws(types, B, n, generator, pts.device)
    mask = None
    if masks_points(types):
        mask = torch.ones((B, n), dtype=torch.bool, device=pts.device)
    for i, fam in enumerate(families):
        if fam is not None:
            pts, mask = fam.apply(pts, mask, draws.levels[:, i], draws.ops[i])
    cap = corruption_capacity(n, types)
    if pts.shape[1] < cap:
        pad = cap - pts.shape[1]
        pts = torch.cat([pts, pts.new_zeros((B, pad, 3))], 1)
        mask = torch.cat([torch.ones((B, n), dtype=torch.bool, device=pts.device)
                          if mask is None else mask,
                          torch.zeros((B, pad), dtype=torch.bool, device=pts.device)], 1)
    return pts, mask
