"""Shared model utilities (port of ``point_dae_tpu/models/common.py``)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def folding_grid(grid_dims: Tuple[int, int],
                 scale: Tuple[float, float] = (-0.3, 0.3)) -> np.ndarray:
    """2-D folding seed grid as itertools.product of linspaces:
    (grid_dims[0] * grid_dims[1], 2) f32."""
    x = np.linspace(scale[0], scale[1], grid_dims[0])
    y = np.linspace(scale[0], scale[1], grid_dims[1])
    return np.array(list(itertools.product(x, y)), dtype=np.float32)


def apply_input_dropout(pts: torch.Tensor, corrupt_type: Sequence[str]) -> torch.Tensor:
    """The in-forward corruption switch of the DGCNN models
    (``models/common.py:66-86``). The three in-model dropouts are not
    ported yet; every other corruption name already ran in the data
    pipeline and is a no-op here."""
    for item in corrupt_type:
        if (item in ("dropout_patch_pointmae", "random_dropout")
                or item.startswith("dropout_global")):
            raise NotImplementedError(f"in-model corruption {item!r} is not ported yet")
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
