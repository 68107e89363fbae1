"""Patch-level corruption (port of
``point_dae_tpu/data/corruptions_patch.py:45-317``): each family acts
jointly on absolute patch coordinates (B, G, S, 3) and their centres
(B, G, 3), with per-sample parameters; ``corrupt_patches_multi`` applies
one affine draw to every scale of a pyramid.

Reference quirks kept: the affine families and 'affine_r3' pin the
severity level to 4; the tensor library's translate multiplies instead of
adding; its reflection is diag(r0 r2, r1, 1), so z never flips (drawn as
two signs on x and y); 'scan' ignores its level; 'dropout_global' and
'add_local' keep S points a patch (refilled from the kept points, and
noised copies in place of random originals).

Every random draw is an input: ``corrupt_patches`` and
``corrupt_patches_multi`` take one entry per ``corrupt_type`` position
(``sample_patch_draws``, ``sample_patch_multi_draws``). A name outside
``PATCH_SUPPORTED`` raises NotImplementedError, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AFFINE_NAMES = ("translate", "scale_nonorm", "rotate", "reflection", "shear")
PATCH_SUPPORTED = frozenset(AFFINE_NAMES) | {
    "clean", "Drop-Patch", "affine_r3", "rotate_z", "jitter",
    "dropout_global", "add_local", "scan"}
LEVEL = 4.0                  # the pinned severity level


def _batched_rot(angles: torch.Tensor) -> torch.Tensor:
    """(B, 3) Euler angles -> (B, 3, 3), R = Rz @ Ry @ Rx for x @ R."""
    ax, ay, az = angles.unbind(-1)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)

    def m(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    rx = m([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = m([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = m([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return rz @ (ry @ rx)


def _uniform(shape, lo, hi, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


@dataclass
class PatchAffineDraws:
    """One affine family's per-sample transform x -> (x * m) @ A + b."""
    A: torch.Tensor              # (B, 3, 3)
    b: torch.Tensor              # (B, 3)
    m: torch.Tensor              # (B, 3)


def sample_params(name: str, batch: int, generator: Optional[torch.Generator],
                  device) -> PatchAffineDraws:
    """``_params`` of one of AFFINE_NAMES or 'rotate_z' at level 4."""
    eye = torch.eye(3, device=device).expand(batch, 3, 3)
    zeros = torch.zeros(batch, 3, device=device)
    ones = torch.ones(batch, 3, device=device)
    if name == "translate":          # s = 0.5, multiplicative as in the reference
        return PatchAffineDraws(eye, zeros, _uniform((batch, 3), -0.5, 0.5, generator, device))
    if name == "scale_nonorm":       # s = 2.0
        return PatchAffineDraws(eye, zeros, _uniform((batch, 3), 0.5, 2.0, generator, device))
    if name == "rotate":             # clip = pi (level + 1) / 5
        clip = math.pi / 5.0 * (LEVEL + 1.0)
        ang = _uniform((batch, 3), -clip, clip, generator, device)
        return PatchAffineDraws(_batched_rot(ang), zeros, ones)
    if name == "rotate_z":           # a full z rotation, level unused
        ang = torch.zeros(batch, 3, device=device)
        ang[:, 2] = _uniform((batch,), -math.pi, math.pi, generator, device)
        return PatchAffineDraws(_batched_rot(ang), zeros, ones)
    if name == "reflection":         # diag(r0 r2, r1, 1): two signs on x and y
        signs = torch.where(torch.rand((batch, 2), generator=generator, device=device) < 0.5,
                            1.0, -1.0)
        return PatchAffineDraws(eye, zeros,
                                torch.cat([signs, torch.ones(batch, 1, device=device)], 1))
    if name == "shear":              # clip = (level + 1) 0.1
        clip = (LEVEL + 1.0) * 0.1
        s = _uniform((batch, 6), -clip, clip, generator, device)
        o = torch.ones(batch, device=device)
        A = torch.stack([torch.stack([o, s[:, 0], s[:, 1]], -1),
                         torch.stack([s[:, 2], o, s[:, 3]], -1),
                         torch.stack([s[:, 4], s[:, 5], o], -1)], -2)
        return PatchAffineDraws(A, zeros, ones)
    raise NotImplementedError(name)


@dataclass
class AffineR3Draws:
    """The draws of one 'affine_r3' corruption: how many of the five
    families apply (1..3), in which order, and every family's per-sample
    parameters as ``x -> (x * m) @ A + b``."""
    count: int
    perm: Sequence[int]          # (5,) permutation of AFFINE_NAMES indices
    A: torch.Tensor              # (5, B, 3, 3)
    b: torch.Tensor              # (5, B, 3)
    m: torch.Tensor              # (5, B, 3)


def sample_affine_r3(batch: int, generator: Optional[torch.Generator],
                     device) -> AffineR3Draws:
    """Draw an 'affine_r3' composite at level 4 (``_sample_affine_r3``)."""
    count = int(torch.randint(1, 4, (), generator=generator, device=device))
    perm = torch.randperm(len(AFFINE_NAMES), generator=generator,
                          device=device).tolist()
    ps = [sample_params(name, batch, generator, device) for name in AFFINE_NAMES]
    return AffineR3Draws(count, perm, torch.stack([p.A for p in ps]),
                         torch.stack([p.b for p in ps]), torch.stack([p.m for p in ps]))


def _apply(neigh, center, A, b, m):
    """x -> (x * m) @ A + b on the patches and on their centres."""
    neigh = (neigh * m[:, None, None, :]) @ A[:, None] + b[:, None, None, :]
    center = (center * m[:, None, :]) @ A + b[:, None, :]
    return neigh, center


def affine_r3_patches(draws: AffineR3Draws, neigh: torch.Tensor,
                      center: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the first ``count`` families of the drawn order. (The JAX
    package also applies the remaining slots as identities, which changes
    no bit.)"""
    for slot in range(draws.count):
        j = draws.perm[slot]
        neigh, center = _apply(neigh, center, draws.A[j], draws.b[j], draws.m[j])
    return neigh, center


@dataclass
class PatchJitterDraws:
    """'jitter' at level 4 (sigma 0.05): standard normals of both tensors."""
    neigh: torch.Tensor          # (B, G, S, 3)
    center: torch.Tensor         # (B, G, 3)


@dataclass
class PatchDropoutDraws:
    """'dropout_global' at level 4: a random order of each patch (from the
    uniforms r) keeps its first S/4 points and refills the other slots with
    kept points (fill, in [0, S/4))."""
    r: torch.Tensor              # (B, G, S) uniforms
    fill: torch.Tensor           # (B, G, S) int


@dataclass
class PatchAddLocalDraws:
    """'add_local' at level 4: one sigma for the whole batch, a random order
    of each patch (from r) and the noise of its first add_n slots."""
    sigma: torch.Tensor          # () in (0.075, 0.125)
    r: torch.Tensor              # (B, G, S) uniforms
    noise: torch.Tensor          # (B, G, S, 3) standard normal


@dataclass
class PatchScanDraws:
    """'scan': one view direction for the whole batch (normalised in the
    function) and a uniform a point."""
    view: torch.Tensor           # (3,) standard normal
    r: torch.Tensor              # (B, G, S) uniforms


def _dropout_keep(S: int) -> int:
    """int(S (1 - 0.75)) in f32: the points a patch keeps at level 4."""
    return int(np.float32(S) * (np.float32(1.0) - np.float32(0.75)))


def _add_local_count(S: int) -> int:
    """The noised slots a patch at level 4: S (l + 1) 0.1 / (1 + (l + 1) 0.1)."""
    return int(np.float32(S * (LEVEL + 1.0) * 0.1 / (1.0 + (LEVEL + 1.0) * 0.1)))


def _jitter_draws(B, G, S, g, dev):
    return PatchJitterDraws(torch.randn((B, G, S, 3), generator=g, device=dev),
                            torch.randn((B, G, 3), generator=g, device=dev))


def _dropout_draws(B, G, S, g, dev):
    return PatchDropoutDraws(
        torch.rand((B, G, S), generator=g, device=dev),
        torch.randint(0, max(_dropout_keep(S), 1), (B, G, S), generator=g, device=dev))


def _add_local_draws(B, G, S, g, dev):
    return PatchAddLocalDraws(_uniform((), 0.075, 0.125, g, dev),
                              torch.rand((B, G, S), generator=g, device=dev),
                              torch.randn((B, G, S, 3), generator=g, device=dev))


def _scan_draws(B, G, S, g, dev):
    return PatchScanDraws(torch.randn((3,), generator=g, device=dev),
                          torch.rand((B, G, S), generator=g, device=dev))


def _jitter_patches(d, neigh, center):
    sigma = 0.01 * (LEVEL + 1.0)
    return neigh + sigma * d.neigh, center + sigma * d.center


# each PATCH_SUPPORTED name but the no-ops: (its draws (B, G, S, generator,
# device), its apply (draws, neigh, center) -> (neigh, center))
_FAMILIES = {
    "affine_r3": (lambda B, G, S, g, dev: sample_affine_r3(B, g, dev),
                  lambda d, neigh, center: affine_r3_patches(d, neigh, center)),
    **{t: (lambda B, G, S, g, dev, t=t: sample_params(t, B, g, dev),
           lambda d, neigh, center: _apply(neigh, center, d.A, d.b, d.m))
       for t in AFFINE_NAMES + ("rotate_z",)},
    "jitter": (_jitter_draws, _jitter_patches),
    "dropout_global": (_dropout_draws,
                       lambda d, neigh, center: (dropout_global_patches(d, neigh), center)),
    "add_local": (_add_local_draws,
                  lambda d, neigh, center: (add_local_patches(d, neigh), center)),
    "scan": (_scan_draws,
             lambda d, neigh, center: (scan_density_patches(d, neigh, center), center)),
}
_NOOPS = ("clean", "Drop-Patch")


def _family(t: str):
    """(sample, apply) of one name, None for 'clean' and 'Drop-Patch' (the
    encoder masks); NotImplementedError outside PATCH_SUPPORTED."""
    if t in _NOOPS:
        return None
    if t not in _FAMILIES:
        raise NotImplementedError(f"patch corruption {t!r}")
    return _FAMILIES[t]


def sample_patch_draws(types: Sequence[str], batch: int, num_group: int,
                       group_size: int, generator: Optional[torch.Generator],
                       device) -> List:
    """One entry per position of ``types`` (None for 'clean' and
    'Drop-Patch'); raises NotImplementedError outside PATCH_SUPPORTED."""
    out = []
    for fam in [_family(t) for t in types]:
        out.append(None if fam is None
                   else fam[0](batch, num_group, group_size, generator, device))
    return out


def _take_slots(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, G, S, 3) rows idx (B, G, S') along the patch axis."""
    return torch.gather(a, 2, idx[..., None].expand(-1, -1, -1, a.shape[-1]))


def dropout_global_patches(draws: PatchDropoutDraws, neigh: torch.Tensor) -> torch.Tensor:
    S = neigh.shape[2]
    order = torch.sort(draws.r, dim=-1, stable=True).indices
    slot = torch.arange(S, device=neigh.device)
    src = torch.where(slot < _dropout_keep(S), slot, draws.fill.long())
    return _take_slots(neigh, torch.gather(order, -1, src))


def add_local_patches(draws: PatchAddLocalDraws, neigh: torch.Tensor) -> torch.Tensor:
    S = neigh.shape[2]
    order = torch.sort(draws.r, dim=-1, stable=True).indices
    perm = _take_slots(neigh, order)
    noised = perm + draws.sigma * draws.noise
    slot = torch.arange(S, device=neigh.device)[:, None]
    return torch.where(slot < _add_local_count(S), noised, perm)


def scan_density_patches(draws: PatchScanDraws, neigh: torch.Tensor,
                         center: torch.Tensor) -> torch.Tensor:
    """Keep a point where |p - v| / 2 < r, else put its patch centre there."""
    def norm3(d):
        return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])

    v = draws.view / norm3(draws.view).clamp_min(1e-12)
    keep = norm3(neigh - v) / 2.0 < draws.r
    return torch.where(keep[..., None], neigh, center[:, :, None, :])


def corrupt_patches(neigh: torch.Tensor, center: torch.Tensor, types: Sequence[str],
                    draws: Optional[Sequence] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``corrupt_patches``: neigh (B, G, S, 3) in absolute coordinates,
    center (B, G, 3). 'clean' and 'Drop-Patch' are no-ops (the encoder
    masks). ``draws``: one entry per position, or None to sample them."""
    families = [_family(t) for t in types]
    if draws is None:
        B, G, S = neigh.shape[:3]
        draws = sample_patch_draws(types, B, G, S, generator, neigh.device)
    for fam, d in zip(families, draws):
        if fam is not None:
            neigh, center = fam[1](d, neigh, center)
    return neigh, center


_MULTI = frozenset(AFFINE_NAMES) | {"affine_r3", "rotate_z"}


def _multi_family(t: str):
    """The (sample, apply) of a family that ``corrupt_patches_multi`` takes
    (the affine ones), None for the no-ops; NotImplementedError else."""
    if t in _NOOPS:
        return None
    if t not in _MULTI:
        raise NotImplementedError(f"list patch corruption {t!r}")
    return _FAMILIES[t]


def sample_patch_multi_draws(types: Sequence[str], batch: int,
                             generator: Optional[torch.Generator], device) -> List:
    """``corrupt_patches_multi``'s draws: one entry per position of
    ``types`` (None for 'clean' and 'Drop-Patch')."""
    return [None if fam is None else fam[0](batch, 0, 0, generator, device)
            for fam in [_multi_family(t) for t in types]]


def corrupt_patches_multi(neighs: Sequence[torch.Tensor], centers: Sequence[torch.Tensor],
                          types: Sequence[str], draws: Optional[Sequence] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The list variant (``corruptions_patch.py:173-194``): each affine
    family's one per-sample transform applied to every (neigh, center)
    scale pair of a pyramid, in absolute coordinates. Only the affine
    families (and the no-ops) are taken, as in the reference; another name
    raises NotImplementedError. ``draws``: one entry per position, or None
    to sample them."""
    families = [_multi_family(t) for t in types]
    if draws is None:
        draws = sample_patch_multi_draws(types, neighs[0].shape[0], generator,
                                         neighs[0].device)
    neighs, centers = list(neighs), list(centers)
    for fam, d in zip(families, draws):
        if fam is None:
            continue
        for s in range(len(neighs)):
            neighs[s], centers[s] = fam[1](d, neighs[s], centers[s])
    return neighs, centers
