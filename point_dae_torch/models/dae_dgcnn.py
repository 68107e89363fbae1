"""DGCNN-backbone DAE pretraining models and heads (port of
``point_dae_tpu/models/dae_dgcnn.py``): ``Point_CAE_DGCNN_FCOnly`` (FC
decoder), ``Point_CAE_DGCNN`` and ``Point_CAE_DGCNN_proj`` (the PCN
decoder, ``layers.pcn_decode``), ``Point_CAE_DGCNN_FoldOnly`` (two
folding stages over a 32 x 32 grid), ``Point_AE_Corruption_DGCNN`` (the
corrupted cloud as its target); the classification model ``DGCNN``, the
linear probe ``DGCNN_Linear``, the extractors ``DGCNN_feat`` and
``DGCNN_MaskFeat``, ``DGCNN_CrossPoint``; and the same heads and the PCN
DAEs over the part-segmentation encoder (``dgcnn.DGCNNPartSegEncoder``):
``Point_CAE_DGCNN_PartSeg``, ``Point_CAE_DGCNN_proj_PartSeg``,
``DGCNN_PartSeg``, ``DGCNN_Linear_PartSeg``, ``DGCNN_feat_PartSeg``.

Calling convention: ``model(corrupted, clean) -> (loss_xyz, loss_normal)``;
``encode`` returns the global feature. Of the configured corruptions the
in-model dropouts (``dropout_patch_pointmae``, ``dropout_global*``,
``random_dropout``) run at the top of a training forward, from given
``DropoutDraws`` or from the generator; the others run in the data
pipeline. Torch names follow the reference (``folding1.{0,2,4}``,
``folding2.{0,2,4}``, ``proj.{0,2}``, ``recfc``); the part-segmentation
encoder's DAEs, which the JAX converter has no rules for, take the same
decoder names.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..utils.registry import MODELS
from .common import (ClsDraws, DropoutDAE, DropoutDraws, dropout_from_mask, folding_grid,
                     sample_dropout_masks)
from .dgcnn import DGCNNEncoder, DGCNNPartSegEncoder
from .layers import MLP, BatchNorm, Dense, SplitMLP, leaky_relu02, pcn_decode


class _DGCNNDAEBase(DropoutDAE):
    """Shared skeleton: input dropout -> DGCNN encoder -> decode -> chamfer.
    Model keys: ``dtype: bf16`` (encoder products in bf16; kNN geometry,
    BatchNorm statistics, decoder and loss stay f32), ``edgeconv_impl``
    (default ``auto``), ``edgeconv_exact_grads``, ``edgeconv_grad_mode``,
    ``edgeconv_knn`` (``kernel``, the default, or ``xla``: the hybrid kNN,
    which the JAX package reads from ``PDAE_EDGECONV_KNN``)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config)
        self.dgcnn_encoder = self._encoder(config, generator)

    @staticmethod
    def _encoder(config, generator):
        bf16 = str(config.get("dtype")) in ("bf16", "bfloat16")
        return DGCNNEncoder(
            remat=bool(config.get("remat", False)),
            dtype=torch.bfloat16 if bf16 else None,
            impl=config.get("edgeconv_impl", "auto"),
            exact_grads=bool(config.get("edgeconv_exact_grads", False)),
            grad_mode=str(config.get("edgeconv_grad_mode", "first")),
            knn_impl=str(config.get("edgeconv_knn", "kernel")),
            generator=generator)

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


def _cls_dim(config, default: Optional[int]) -> int:
    """``config["cls_dim"]``, or ``default`` where that is not None."""
    return int(config["cls_dim"] if default is None else config.get("cls_dim", default))


class _DGCNNEncoderModel(nn.Module):
    """A model around the f32 DGCNN encoder with the fine-tune model's
    encoder keys (``edgeconv_impl``, ``edgeconv_exact_grads``,
    ``edgeconv_knn``)."""
    DEFAULT_CLS = 40

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dgcnn_encoder = self._encoder(config, generator)

    @staticmethod
    def _encoder(config, generator):
        return DGCNNEncoder(impl=config.get("edgeconv_impl", "auto"),
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
        self.cls_head_finetune = _ClsHead(_cls_dim(config, self.DEFAULT_CLS), generator)

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
        self.cls = Dense(1024, _cls_dim(config, self.DEFAULT_CLS), generator=generator)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls(self.encode(pts))


@MODELS.register_module()
class DGCNN_feat(_DGCNNEncoderModel):
    """SVM feature extractor: ``model(pts) -> (B, 1024)``."""

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.encode(pts)


@MODELS.register_module()
class Point_CAE_DGCNN(_DGCNNDAEBase):
    """The PCN decoder: ``folding1`` to 1024 coarse points, ``folding2``
    over a 4 x 4 grid (+-0.05) around each, 16384 fine points. Returns
    (loss_coarse, loss_fine)."""
    num_coarse = 1024

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.folding1 = MLP(1024, (1024, 1024, self.num_coarse * 3), generator=generator)
        self.folding2 = SplitMLP(1024, 5, (512, 512, 3), generator=generator, shared_last=True)

    def _project(self, feat: torch.Tensor) -> torch.Tensor:
        return feat

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        clean = clean[..., :3].contiguous()
        feat = self._project(self._encode_corrupted(corrupted, draws, generator))
        coarse, fine = pcn_decode(feat, self.folding1, self.folding2, self.num_coarse)
        return self.loss_func(coarse, clean), self.loss_func(fine, clean)


@MODELS.register_module()
class Point_CAE_DGCNN_proj(Point_CAE_DGCNN):
    """``Point_CAE_DGCNN`` with a 1024 -> 512 -> 1024 projection between
    the encoder and the decoder."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.proj = MLP(1024, (512, 1024), generator=generator)

    def _project(self, feat: torch.Tensor) -> torch.Tensor:
        return self.proj(feat)


@MODELS.register_module()
class Point_CAE_DGCNN_FoldOnly(_DGCNNDAEBase):
    """Two folding stages over a 32 x 32 grid (+-0.3): ``folding1`` over
    ``[global | grid]``, ``folding2`` over ``[global | folding1's
    points]``, 1024 -> 1024 -> 3 each. Returns (loss, 0)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.folding1 = SplitMLP(1024, 2, (1024, 1024, 3), generator=generator)
        self.folding2 = SplitMLP(1024, 3, (1024, 1024, 3), generator=generator)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        feat = self._encode_corrupted(corrupted, draws, generator)
        grid = torch.from_numpy(folding_grid((32, 32), (-0.3, 0.3))).to(feat.device)
        f1 = self.folding1(feat, grid.expand(feat.shape[0], -1, -1))
        loss = self.loss_func(self.folding2(feat, f1), clean[..., :3].contiguous())
        return loss, torch.zeros((), device=loss.device)


@MODELS.register_module()
class Point_AE_Corruption_DGCNN(_DGCNNDAEBase):
    """The FC decoder of ``Point_CAE_DGCNN_FCOnly`` with the corrupted
    cloud (before the in-model dropouts) as its target. Returns (loss, 0)."""
    num_coarse = 1024

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.recfc = MLP(1024, (1024, 1024, self.num_coarse * 3), generator=generator)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        target = corrupted[..., :3].contiguous()
        feat = self._encode_corrupted(corrupted, draws, generator)
        loss = self.loss_func(self.recfc(feat).reshape(-1, self.num_coarse, 3), target)
        return loss, torch.zeros((), device=loss.device)


@MODELS.register_module()
class DGCNN_MaskFeat(DGCNN_feat):
    """The MaskFeat probe's extractor: ``model(pts) -> (B, 1024)``."""


@MODELS.register_module()
class DGCNN_CrossPoint(DGCNN):
    """``DGCNN`` whose ``cls_dim`` defaults to 15 (ScanObjectNN)."""
    DEFAULT_CLS = 15


class _DGCNNPartSegDAEBase(_DGCNNDAEBase):
    """``_DGCNNDAEBase`` over the part-segmentation encoder (f32; it takes
    none of the encoder keys)."""

    @staticmethod
    def _encoder(config, generator):
        return DGCNNPartSegEncoder(generator=generator)


@MODELS.register_module()
class Point_CAE_DGCNN_PartSeg(_DGCNNPartSegDAEBase, Point_CAE_DGCNN):
    """``Point_CAE_DGCNN`` over the part-segmentation encoder."""


@MODELS.register_module()
class Point_CAE_DGCNN_proj_PartSeg(_DGCNNPartSegDAEBase, Point_CAE_DGCNN_proj):
    """``Point_CAE_DGCNN_proj`` over the part-segmentation encoder."""


class _PartSegEncoderModel(_DGCNNEncoderModel):
    """A model around the part-segmentation encoder."""

    @staticmethod
    def _encoder(config, generator):
        return DGCNNPartSegEncoder(generator=generator)


@MODELS.register_module()
class DGCNN_PartSeg(_PartSegEncoderModel, DGCNN):
    """``DGCNN``'s head on the part-segmentation encoder; ``cls_dim`` has no
    default (a config without it raises ``KeyError``, as in JAX)."""
    DEFAULT_CLS = None


@MODELS.register_module()
class DGCNN_Linear_PartSeg(_PartSegEncoderModel, DGCNN_Linear):
    """``DGCNN_Linear`` on the part-segmentation encoder; ``cls_dim`` has no
    default."""
    DEFAULT_CLS = None


@MODELS.register_module()
class DGCNN_feat_PartSeg(_PartSegEncoderModel, DGCNN_feat):
    """The part-segmentation encoder's global feature: ``model(pts) -> (B,
    1024)``."""
