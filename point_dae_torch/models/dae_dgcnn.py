"""DGCNN-backbone DAE pretraining models (port of
``point_dae_tpu/models/dae_dgcnn.py:31-92``): ``Point_CAE_DGCNN_FCOnly``;
the classification fine-tune model ``DGCNN`` (``:202-236``), the linear
probe ``DGCNN_Linear`` and the SVM feature extractor ``DGCNN_feat``
(``:239-264``).

Calling convention: ``model(corrupted, clean) -> (loss_xyz, loss_normal)``;
``encode`` returns the global feature. Of the configured corruptions the
in-model dropouts (``dropout_patch_pointmae``, ``dropout_global*``,
``random_dropout``) run at the top of a training forward, from given
``DropoutDraws`` or from the generator; the others run in the data
pipeline.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..losses.chamfer import build_loss_func
from ..utils.registry import MODELS
from .common import (ClsDraws, DropoutDraws, apply_input_dropout, dropout_from_mask,
                     is_input_dropout, sample_dropout_draws, sample_dropout_masks)
from .dgcnn import DGCNNEncoder
from .layers import MLP, BatchNorm, Dense, leaky_relu02


class _DGCNNDAEBase(nn.Module):
    """Shared skeleton: input dropout -> DGCNN encoder -> decode -> chamfer.
    Model keys: ``dtype: bf16`` (encoder products in bf16; kNN geometry,
    BatchNorm statistics, decoder and loss stay f32), ``edgeconv_impl``
    (default ``auto``), ``edgeconv_exact_grads``, ``edgeconv_grad_mode``,
    ``edgeconv_knn`` (``kernel``, the default, or ``xla``: the hybrid kNN,
    which the JAX package reads from ``PDAE_EDGECONV_KNN``)."""

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
            knn_impl=str(config.get("edgeconv_knn", "kernel")),
            generator=generator)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator], device,
                     n: int = 1024) -> List[DropoutDraws]:
        """Draw the in-model dropouts' randomness (clouds of ``n`` points)."""
        return [sample_dropout_draws(t, batch, n, generator, device)
                for t in self.corrupt_type if is_input_dropout(t)]

    def _encode_corrupted(self, corrupted: torch.Tensor,
                          draws: Optional[Sequence[DropoutDraws]] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        corrupted = corrupted[..., :3]
        if self.training and self.corrupt_type:
            corrupted = apply_input_dropout(corrupted, self.corrupt_type, draws, generator)
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

    def reconstruct(self, corrupted: torch.Tensor,
                    draws: Optional[Sequence[DropoutDraws]] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self._encode_corrupted(corrupted, draws, generator)
        return self.recfc(feat).reshape(-1, self.num_coarse, 3)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        """``draws``: one ``DropoutDraws`` for each in-model dropout of the
        model's ``corrupt_type``, or None to draw them from ``generator``."""
        coarse = self.reconstruct(corrupted, draws, generator)
        loss = self.loss_func(coarse, clean[..., :3].contiguous())
        return loss, torch.zeros((), device=loss.device)


class _ClsHead(nn.Sequential):
    """DGCNN classification head (``dae_dgcnn.py:202-222``): Dense 512 +
    BatchNorm + LeakyReLU(0.2) + Dropout(0.5), Dense 256 + BatchNorm +
    LeakyReLU + Dropout, then the classifier. The torch names follow the
    reference's ``cls_head_finetune`` Sequential (Linear, BN, LeakyReLU,
    Linear, BN, LeakyReLU, Dropout, Linear: parameters at ``0, 1, 3, 4,
    7``); as in the JAX package a dropout follows both stages, with the keep
    masks given as inputs."""

    RATE = 0.5
    DIMS = (512, 256)

    def __init__(self, cls_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__(Dense(1024, 512, generator=generator), BatchNorm(512),
                         nn.LeakyReLU(0.2), Dense(512, 256, generator=generator),
                         BatchNorm(256), nn.LeakyReLU(0.2), nn.Dropout(self.RATE),
                         Dense(256, cls_dim, generator=generator))

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``keep``: the two (B, width) keep masks, or None (eval)."""
        for i, (fc, bn) in enumerate(((0, 1), (3, 4))):
            x = leaky_relu02(self[bn](self[fc](x)))
            if keep is not None:
                x = dropout_from_mask(x, keep[i], self.RATE)
        return self[7](x)


class _DGCNNEncoderModel(nn.Module):
    """A model around the f32 DGCNN encoder with the fine-tune model's
    encoder keys (``edgeconv_impl``, ``edgeconv_exact_grads``,
    ``edgeconv_knn``)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dgcnn_encoder = DGCNNEncoder(
            impl=config.get("edgeconv_impl", "auto"),
            exact_grads=bool(config.get("edgeconv_exact_grads", False)),
            knn_impl=str(config.get("edgeconv_knn", "kernel")),
            generator=generator)

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """The global feature (B, 1024)."""
        return self.dgcnn_encoder(pts[..., :3])[0]


@MODELS.register_module()
class DGCNN(_DGCNNEncoderModel):
    """Classification fine-tune model (``dae_dgcnn.py:225-236``): the f32
    DGCNN encoder (``edgeconv_impl`` default ``auto``: the fused kernel on
    CUDA; ``edgeconv_knn`` as in the pretrain models) and ``_ClsHead`` on its global feature. Calling convention:
    ``model(pts (B, N, 3)) -> logits (B, cls_dim)``; in training the head's
    dropout masks come from ``draws`` or from ``generator``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls_head_finetune = _ClsHead(int(config.get("cls_dim", 40)), generator)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        """Draw a training forward's randomness from ``generator``."""
        return ClsDraws(sample_dropout_masks(batch, _ClsHead.DIMS, _ClsHead.RATE,
                                             generator, device))

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.encode(pts)
        if not self.training:
            return self.cls_head_finetune(feat)
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self.cls_head_finetune(feat, draws.dropout)


@MODELS.register_module()
class DGCNN_Linear(_DGCNNEncoderModel):
    """Linear probe: one Dense (``cls``) on the encoder's global feature.
    It has no random draw; ``draws`` and ``generator`` are taken for the
    fine-tune step's calling convention."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls = Dense(1024, int(config.get("cls_dim", 40)), generator=generator)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls(self.encode(pts))


@MODELS.register_module()
class DGCNN_feat(_DGCNNEncoderModel):
    """SVM feature extractor: ``model(pts) -> (B, 1024)``."""

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.encode(pts)
