"""Model zoo of the port. Importing this package populates ``MODELS``."""
from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.registry import MODELS
from . import dae_dgcnn, dvae, maskfeat, masksurf, partseg, transformer  # noqa: F401


def build_model_from_cfg(cfg, device=None, seed: int = 0,
                         generator: Optional[torch.Generator] = None):
    """``cfg.NAME`` selects the constructor; the whole model config is
    passed through. Weights are drawn on the CPU from ``generator`` (or a
    generator seeded with ``seed``) and moved to ``device`` (default CUDA;
    without a card this raises unless ``device='cpu'``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return MODELS.build(cfg, generator=generator).to(dev)
