"""Shared model utilities (port of ``point_dae_tpu/models/common.py``)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..losses.chamfer import build_loss_func
from ..ops.geometry import fps_knn, group_points, resample_batch

PATCH_GROUPS, PATCH_SIZE = 64, 32     # dropout_patch_pointmae's patchify


def folding_grid(grid_dims: Tuple[int, int],
                 scale: Tuple[float, float] = (-0.3, 0.3)) -> np.ndarray:
    """2-D folding seed grid as itertools.product of linspaces:
    (grid_dims[0] * grid_dims[1], 2) f32."""
    x = np.linspace(scale[0], scale[1], grid_dims[0])
    y = np.linspace(scale[0], scale[1], grid_dims[1])
    return np.array(list(itertools.product(x, y)), dtype=np.float32)


@dataclass
class DropoutDraws:
    """The draws of one in-model dropout (``models/common.py:29-86`` of the
    JAX package): ``resample`` (B, N), ranks into each cloud's surviving
    points or uniforms in [0, 1) (``resample_batch``); for
    ``dropout_patch_pointmae`` the ``level`` (a scalar ~ U(0, 4)) and the
    patch uniforms ``patch_u`` (G,), shared by the batch; for
    ``dropout_global*`` the ranking uniforms ``rank_u`` (B, N); for
    ``random_dropout`` the ``coin`` (a scalar ~ U(0, 1)) and the fields of
    both branches."""
    resample: torch.Tensor
    level: Optional[torch.Tensor] = None
    patch_u: Optional[torch.Tensor] = None
    rank_u: Optional[torch.Tensor] = None
    coin: Optional[torch.Tensor] = None


def is_input_dropout(item: str) -> bool:
    """The corruption names the DGCNN models apply inside their forward."""
    return item in ("dropout_patch_pointmae", "random_dropout") or \
        item.startswith("dropout_global")


def sample_dropout_draws(item: str, batch: int, n: int, generator: Optional[torch.Generator],
                         device, num_group: int = PATCH_GROUPS) -> DropoutDraws:
    """Draw one in-model dropout's randomness from ``generator``."""
    rand = lambda *shape: torch.rand(shape, generator=generator, device=device)
    patch = item in ("dropout_patch_pointmae", "random_dropout")
    glob = item != "dropout_patch_pointmae"
    return DropoutDraws(resample=rand(batch, n),
                        level=rand() * 4.0 if patch else None,
                        patch_u=rand(num_group) if patch else None,
                        rank_u=rand(batch, n) if glob else None,
                        coin=rand() if item == "random_dropout" else None)


def dropout_patch_pointmae(pts: torch.Tensor, draws: DropoutDraws,
                           num_group: int = PATCH_GROUPS,
                           group_size: int = PATCH_SIZE) -> torch.Tensor:
    """Patchify (FPS + kNN) and drop whole patches with probability
    level / 10 + 0.5, one patch mask for the batch, patch 0 kept when none
    survives; the survivors are resampled back to N points."""
    B, N, _ = pts.shape
    prob = draws.level / 10.0 + 0.5
    _, _, idx = fps_knn(pts, num_group, group_size)         # (B, G, S)
    keep = draws.patch_u > prob
    keep = torch.cat([keep[:1] | ~keep.any(), keep[1:]])
    flat = group_points(pts, idx).reshape(B, num_group * group_size, 3)
    mask = keep[None, :, None].expand(B, num_group, group_size).reshape(B, -1)
    return resample_batch(flat, mask, N, draws=draws.resample)


def dropout_global(pts: torch.Tensor, draws: DropoutDraws, drop_rate: float = 0.5
                   ) -> torch.Tensor:
    """Keep the int(N * (1 - drop_rate)) points of lowest ranking uniform
    (in Python float arithmetic, as the JAX package computes the count);
    the survivors are resampled back to N points."""
    B, N, _ = pts.shape
    keep_n = int(N * (1.0 - drop_rate))
    order = torch.argsort(draws.rank_u, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(N, device=pts.device).expand(B, -1))
    return resample_batch(pts, rank < keep_n, N, draws=draws.resample)


def apply_input_dropout(pts: torch.Tensor, corrupt_type: Sequence[str],
                        draws: Optional[Sequence[DropoutDraws]] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The in-forward corruption switch of the DGCNN models
    (``models/common.py:66-86``). ``draws`` holds one ``DropoutDraws`` for
    each in-model dropout of ``corrupt_type``, in order (sampled from
    ``generator`` when None); every other corruption name already ran in
    the data pipeline and is a no-op here."""
    items = [t for t in corrupt_type if is_input_dropout(t)]
    if draws is None:
        draws = [sample_dropout_draws(t, pts.shape[0], pts.shape[1], generator, pts.device)
                 for t in items]
    if len(draws) != len(items):
        raise ValueError(f"{len(draws)} dropout draws for the in-model dropouts {items}")
    for item, d in zip(items, draws):
        if item == "dropout_patch_pointmae":
            pts = dropout_patch_pointmae(pts, d)
        elif item == "dropout_global":
            pts = dropout_global(pts, d, 0.5)
        elif item.startswith("dropout_global_p"):
            pts = dropout_global(pts, d, int(item[len("dropout_global_p"):]) / 10.0)
        elif bool(d.coin > 0.5):                 # random_dropout: one batch-wide coin
            pts = dropout_patch_pointmae(pts, d)
        else:
            pts = dropout_global(pts, d, 0.5)
    return pts


@dataclass
class ClsDraws:
    """Every random draw of one training forward of a classification
    model: the head's dropout keep masks (one (B, width) bool a Dropout, in
    order) and the stochastic-depth keep masks ((depth, 2, B) bool, or None
    for a model without them)."""
    dropout: Sequence[torch.Tensor]
    drop_path: Optional[torch.Tensor] = None


def dropout_from_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with a given keep mask: kept elements scaled by
    1 / (1 - rate), the others zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def sample_dropout_masks(batch: int, widths: Sequence[int], rate: float,
                         generator: Optional[torch.Generator], device) -> list:
    """Keep masks (B, width) bool, kept with probability 1 - rate."""
    return [torch.rand((batch, w), generator=generator, device=device) >= rate
            for w in widths]


class DropoutDAE(nn.Module):
    """The pretrain skeleton of the CNN DAEs (JAX ``dae_dgcnn.py:29-68``,
    ``dae_pointnet2.py:113-133``, ``dae_pointnet.py:80-101``): the
    configured in-model dropouts on the corrupted points, then ``encode``;
    ``loss_func`` is the configured chamfer (default ``cdl2``). Calling
    convention of a subclass: ``model(corrupted, clean, draws=None,
    generator=None) -> (loss, loss)``, ``draws`` one ``DropoutDraws`` for
    each in-model dropout of ``corrupt_type`` (None: drawn from
    ``generator``). A subclass with ``INPUT_DROPOUT = False`` runs none."""
    INPUT_DROPOUT = True

    def __init__(self, config):
        super().__init__()
        self.corrupt_type = tuple(config.get("corrupt_type", ()))
        self.loss_func = build_loss_func(config.get("loss", "cdl2"))

    def sample_draws(self, batch: int, generator: Optional[torch.Generator], device,
                     n: int = 1024) -> list:
        """Draw the in-model dropouts' randomness (clouds of ``n`` points)."""
        return [sample_dropout_draws(t, batch, n, generator, device)
                for t in self.corrupt_type if self.INPUT_DROPOUT and is_input_dropout(t)]

    def _encode_corrupted(self, corrupted: torch.Tensor,
                          draws: Optional[Sequence[DropoutDraws]] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        corrupted = corrupted[..., :3]
        if self.training and self.corrupt_type and self.INPUT_DROPOUT:
            corrupted = apply_input_dropout(corrupted, self.corrupt_type, draws, generator)
        return self.encode(corrupted)
