"""PointNet-backbone models (port of ``point_dae_tpu/models/dae_pointnet.py``):
the spatial transformer ``STN(k)``, ``PointNetEncoder`` with and without
the input T-Net, the DAEs ``Point_CAE_PointNet`` / ``_NoT`` (FC decoder
to 1024 x 3), the classification models ``PointNet`` / ``PointNet_NoT``,
the extractors ``PointNet_feat`` / ``PointNet_NoT_feat``, the linear probe
``PointNetNoT_Linear``; the part-segmentation-style encoder (widths 64,
128, 128, 512, 2048) with its DAE ``Point_CAE_PointNetNoT_PartSeg`` (no
input dropout) and heads ``PointNetNoT_PartSeg``,
``PointNetNoT_Linear_PartSeg``, ``PointNetNoT_feat_PartSeg``; and the
reference's spellings ``Point_CAE_PointNetNoT``, ``PointNetNoT``,
``PointNetNoT_feat`` as aliases. f32.

Torch names follow the reference (as the JAX converter's ``pointnet``
family reads them): ``pointnet_encoder.stn.{conv1-3, bn1-5, fc1-3}``,
``pointnet_encoder.{conv1-3, bn1-3}``, the DAE's FC decoder ``folding1.{0,
2, 4}`` (flax ``recfc``) and the head ``cls_head_finetune.{0, 1, 4, 5, 7}``.
The part-segmentation-style encoder, which that converter has no rules for,
takes the reference layout's ``pointnet_encoder.{conv1-5, bn1-5}``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..utils.registry import MODELS
from .common import ClsDraws, DropoutDAE, DropoutDraws, dropout_from_mask, sample_dropout_masks
from .layers import MLP, BatchNorm, Dense


def _conv_bn_relu(conv: Dense, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(bn(conv(x)))


def transform_points(x: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``x (B, N, 3) @ trans (B, 3, 3)`` in f32 as three products summed
    left to right, whatever the matmul precision setting (JAX takes the
    product at HIGHEST precision)."""
    t = trans[:, None]
    return x[..., 0:1] * t[..., 0, :] + x[..., 1:2] * t[..., 1, :] + x[..., 2:3] * t[..., 2, :]


class STN(nn.Module):
    """Spatial transformer predicting a k x k matrix (STN3d / STNkd): a
    pointwise k -> 64 -> 128 -> 1024 stack (Dense + BatchNorm + ReLU), a max
    over the points, 1024 -> 512 -> 256 (Dense + BatchNorm + ReLU) and a
    Dense to k * k; the output is that matrix plus the identity."""

    def __init__(self, k: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        g = generator
        for i, (din, dout) in enumerate(((k, 64), (64, 128), (128, 1024)), start=1):
            setattr(self, f"conv{i}", Dense(din, dout, generator=g))
            setattr(self, f"bn{i}", BatchNorm(dout))
        self.fc1, self.bn4 = Dense(1024, 512, generator=g), BatchNorm(512)
        self.fc2, self.bn5 = Dense(512, 256, generator=g), BatchNorm(256)
        self.fc3 = Dense(256, k * k, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, k) -> (B, k, k)."""
        h = _conv_bn_relu(self.conv1, self.bn1, x)
        h = _conv_bn_relu(self.conv2, self.bn2, h)
        h = _conv_bn_relu(self.conv3, self.bn3, h).amax(1)
        h = _conv_bn_relu(self.fc1, self.bn4, h)
        h = _conv_bn_relu(self.fc2, self.bn5, h)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device)
        return self.fc3(h).reshape(-1, self.k, self.k) + eye


class PointNetEncoder(nn.Module):
    """The PointNet global encoder: the input transform (``stn``, with
    ``use_tnet``) on the xyz, then 3 -> 64 -> 128 -> 1024 pointwise (Dense +
    BatchNorm, ReLU after the first two only) and a max over the points.
    ``feature_transform`` adds the 64 x 64 feature transform (``fstn``)
    after the first layer, as the JAX module does (no model sets it).
    (B, N, 3) -> (B, 1024)."""

    def __init__(self, use_tnet: bool = True, feature_transform: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        if use_tnet:
            self.stn = STN(3, g)
        self.conv1, self.bn1 = Dense(3, 64, generator=g), BatchNorm(64)
        if use_tnet and feature_transform:
            self.fstn = STN(64, g)
        self.conv2, self.bn2 = Dense(64, 128, generator=g), BatchNorm(128)
        self.conv3, self.bn3 = Dense(128, 1024, generator=g), BatchNorm(1024)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[..., :3]
        if hasattr(self, "stn"):
            x = transform_points(x, self.stn(x))
        h = _conv_bn_relu(self.conv1, self.bn1, x)
        if hasattr(self, "fstn"):
            h = torch.matmul(h, self.fstn(h))
        h = _conv_bn_relu(self.conv2, self.bn2, h)
        return self.bn3(self.conv3(h)).amax(1)


class PointNetPartSegStyleEncoder(nn.Module):
    """The part-segmentation-style PointNet (no T-Net): 3 -> 64 -> 128 ->
    128 -> 512 -> 2048 pointwise (Dense + BatchNorm, ReLU after all but the
    last) and a max over the points. (B, N, 3) -> (B, 2048)."""

    WIDTHS = (64, 128, 128, 512, 2048)

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        din = 3
        for i, d in enumerate(self.WIDTHS, start=1):
            setattr(self, f"conv{i}", Dense(din, d, generator=generator))
            setattr(self, f"bn{i}", BatchNorm(d))
            din = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[..., :3]
        n = len(self.WIDTHS)
        for i in range(1, n + 1):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            if i < n:
                h = torch.relu(h)
        return h.amax(1)


def _encoder(kind: str, generator):
    return (PointNetPartSegStyleEncoder(generator) if kind == "partseg"
            else PointNetEncoder(use_tnet=kind == "tnet", generator=generator))


class _PointNetDAE(DropoutDAE):
    """The FC-decoder DAE (``folding1``, 1024 -> 1024 -> 1024 -> 3072) over
    the ``ENCODER`` (``tnet``, ``not`` or ``partseg``). Returns (loss, 0)."""
    ENCODER = "tnet"
    WIDTH = {"tnet": 1024, "not": 1024, "partseg": 2048}
    num_coarse = 1024

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config)
        self.pointnet_encoder = _encoder(self.ENCODER, generator)
        self.folding1 = MLP(self.WIDTH[self.ENCODER], (1024, 1024, self.num_coarse * 3),
                            generator=generator)

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """The global feature (B, 1024; 2048 for the part-seg style)."""
        return self.pointnet_encoder(pts)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        feat = self._encode_corrupted(corrupted, draws, generator)
        coarse = self.folding1(feat).reshape(-1, self.num_coarse, 3)
        loss = self.loss_func(coarse, clean[..., :3].contiguous())
        return loss, torch.zeros((), device=loss.device)


@MODELS.register_module()
class Point_CAE_PointNet(_PointNetDAE):
    """The DAE over the T-Net encoder."""


@MODELS.register_module()
class Point_CAE_PointNet_NoT(_PointNetDAE):
    """The DAE over the encoder without the T-Net."""
    ENCODER = "not"


@MODELS.register_module()
class Point_CAE_PointNetNoT_PartSeg(_PointNetDAE):
    """The DAE over the part-segmentation-style encoder; it runs no in-model
    dropout, as in JAX."""
    ENCODER = "partseg"
    INPUT_DROPOUT = False


class _PointNetClsHead(nn.Sequential):
    """Dense 512 + BatchNorm + ReLU, Dense 256, Dropout(0.4), BatchNorm +
    ReLU, then the classifier (the JAX module's order: its one dropout sits
    between ``fc2`` and ``bn2``, with a (B, 256) keep mask as the input).
    Torch names follow the reference's Sequential (Linear, BN, ReLU,
    Dropout, Linear, BN, ReLU, Linear: parameters at ``0, 1, 4, 5, 7``)."""

    RATE = 0.4
    DIMS = (256,)

    def __init__(self, din: int, cls_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__(Dense(din, 512, generator=generator), BatchNorm(512), nn.ReLU(),
                         nn.Dropout(self.RATE), Dense(512, 256, generator=generator),
                         BatchNorm(256), nn.ReLU(), Dense(256, cls_dim, generator=generator))

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``keep``: the one (B, 256) keep mask, or None (eval)."""
        x = self[4](torch.relu(self[1](self[0](x))))
        if keep is not None:
            x = dropout_from_mask(x, keep[0], self.RATE)
        return self[7](torch.relu(self[5](x)))


class _PointNetModel(nn.Module):
    """The ``ENCODER`` under ``pointnet_encoder`` with the fine-tune models'
    calling convention."""
    ENCODER = "tnet"

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pointnet_encoder = _encoder(self.ENCODER, generator)
        self.width = _PointNetDAE.WIDTH[self.ENCODER]

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        return self.pointnet_encoder(pts)


class _PointNetCls(_PointNetModel):
    """The encoder and ``_PointNetClsHead``: ``model(pts (B, N, 3)) ->
    logits (B, cls_dim)``; in training the head's keep mask comes from
    ``draws`` or from ``generator``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls_head_finetune = _PointNetClsHead(self.width, int(config.get("cls_dim", 40)),
                                                  generator)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        """Draw a training forward's randomness from ``generator``."""
        return ClsDraws(sample_dropout_masks(batch, _PointNetClsHead.DIMS,
                                             _PointNetClsHead.RATE, generator, device))

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.encode(pts)
        if not self.training:
            return self.cls_head_finetune(feat)
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self.cls_head_finetune(feat, draws.dropout)


class _PointNetLinear(_PointNetModel):
    """The linear probe: one ``cls`` Dense on the global feature. It has no
    random draw; ``draws`` and ``generator`` are taken for the fine-tune
    step's calling convention."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls = Dense(self.width, int(config.get("cls_dim", 40)), generator=generator)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls(self.encode(pts))


class _PointNetFeat(_PointNetModel):
    """The SVM feature extractor: ``model(pts) -> (B, width)``."""

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.encode(pts)


@MODELS.register_module()
class PointNet(_PointNetCls):
    """Classification over the T-Net encoder."""


@MODELS.register_module()
class PointNet_NoT(_PointNetCls):
    ENCODER = "not"


@MODELS.register_module()
class PointNet_feat(_PointNetFeat):
    """The T-Net encoder's global feature."""


@MODELS.register_module()
class PointNet_NoT_feat(_PointNetFeat):
    ENCODER = "not"


@MODELS.register_module()
class PointNetNoT_Linear(_PointNetLinear):
    ENCODER = "not"


@MODELS.register_module()
class PointNetNoT_PartSeg(_PointNetCls):
    ENCODER = "partseg"


@MODELS.register_module()
class PointNetNoT_Linear_PartSeg(_PointNetLinear):
    ENCODER = "partseg"


@MODELS.register_module()
class PointNetNoT_feat_PartSeg(_PointNetFeat):
    ENCODER = "partseg"


# the reference's spellings (no underscore before "NoT")
MODELS.register_module("Point_CAE_PointNetNoT", module=Point_CAE_PointNet_NoT)
MODELS.register_module("PointNetNoT", module=PointNet_NoT)
MODELS.register_module("PointNetNoT_feat", module=PointNet_NoT_feat)
