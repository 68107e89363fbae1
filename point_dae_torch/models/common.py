"""Shared model utilities (port of ``point_dae_tpu/models/common.py``)."""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

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
