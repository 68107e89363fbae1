"""DGCNN-backbone DAE pretraining models (port of
``point_dae_tpu/models/dae_dgcnn.py:31-92``): ``Point_CAE_DGCNN_FCOnly``.

Calling convention: ``model(corrupted, clean) -> (loss_xyz, loss_normal)``;
``encode`` returns the global feature. The model draws nothing at random:
its configured corruptions run in the data pipeline.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..losses.chamfer import build_loss_func
from ..utils.registry import MODELS
from .common import apply_input_dropout
from .dgcnn import DGCNNEncoder
from .layers import MLP


class _DGCNNDAEBase(nn.Module):
    """Shared skeleton: input dropout -> DGCNN encoder -> decode -> chamfer.
    Model keys: ``dtype: bf16`` (encoder products in bf16; kNN geometry,
    BatchNorm statistics, decoder and loss stay f32), ``edgeconv_impl``
    (default ``auto``), ``edgeconv_exact_grads``, ``edgeconv_grad_mode``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.corrupt_type = tuple(config.get("corrupt_type", ()))
        bf16 = str(config.get("dtype")) in ("bf16", "bfloat16")
        self.loss_func = build_loss_func(config.get("loss", "cdl2"))
        self.dgcnn_encoder = DGCNNEncoder(
            remat=bool(config.get("remat", False)),
            dtype=torch.bfloat16 if bf16 else None,
            impl=config.get("edgeconv_impl", "auto"),
            exact_grads=bool(config.get("edgeconv_exact_grads", False)),
            grad_mode=str(config.get("edgeconv_grad_mode", "first")),
            generator=generator)

    def _encode_corrupted(self, corrupted: torch.Tensor) -> torch.Tensor:
        corrupted = corrupted[..., :3]
        if self.training and self.corrupt_type:
            corrupted = apply_input_dropout(corrupted, self.corrupt_type)
        return self.dgcnn_encoder(corrupted)[0]

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """The global feature (B, 1024) of clean points."""
        return self.dgcnn_encoder(pts[..., :3])[0]


@MODELS.register_module()
class Point_CAE_DGCNN_FCOnly(_DGCNNDAEBase):
    """FC decoder to 1024 x 3: the released non-transformer model."""
    num_coarse = 1024

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.recfc = MLP(1024, (1024, 1024, self.num_coarse * 3), generator=generator)

    def reconstruct(self, corrupted: torch.Tensor) -> torch.Tensor:
        feat = self._encode_corrupted(corrupted)
        return self.recfc(feat).reshape(-1, self.num_coarse, 3)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor, draws=None,
                generator: Optional[torch.Generator] = None):
        """``draws`` and ``generator`` are accepted for the train step's
        uniform call and unused."""
        coarse = self.reconstruct(corrupted)
        loss = self.loss_func(coarse, clean[..., :3].contiguous())
        return loss, torch.zeros((), device=loss.device)
