"""PointNet++ classification (port of
``point_dae_tpu/models/dae_pointnet2.py:31-72,98-111,182-234``): the
set-abstraction encoder SA(512, r 0.2, k 32, [64, 64, 128]) -> SA(128,
r 0.4, k 64, [128, 128, 256]) -> SA(all, [256, 512, 1024]) and the
classes ``PointNetv2`` (the 512 / 256 head with BatchNorm and dropout),
``PointNetv2_Linear`` (one ``cls`` Dense) and ``PointNetv2_feat`` (the
1024-wide feature). f32.

Torch names follow the reference's pointnet2 modules
(``pointnetv2_encoder.sa{j}.mlps.0.layer{i}.conv`` / ``.bn.bn``) and its
``cls_head_finetune`` Sequential. The head's two dropout keep masks are
inputs (``ClsDraws``), as for the transformer fine-tune models.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.geometry import ball_query, furthest_point_sample, gather_points, group_points
from ..utils.registry import MODELS
from .common import ClsDraws, sample_dropout_masks
from .layers import Dense, SharedMLP
from .transformer import _FinetuneHead


class SetAbstraction(nn.Module):
    """FPS to ``npoint`` centres, ``ball_query(radius, nsample)``, the
    grouped xyz relative to the centre with the grouped features after it,
    the shared MLP, max over the ball. ``npoint=None`` groups every point
    into one group around the origin (the global level)."""

    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], din: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlps = nn.ModuleList([SharedMLP(din, mlp, generator)])

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        """xyz (B, N, 3), features (B, N, C) or None -> (centres (B, M, 3),
        features (B, M, mlp[-1]))."""
        if self.npoint is None:
            grouped = xyz[:, None]
            if features is not None:
                grouped = torch.cat([grouped, features[:, None]], -1)
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype, device=xyz.device)
        else:
            new_xyz = gather_points(xyz, furthest_point_sample(xyz, self.npoint))
            nidx = ball_query(self.radius, self.nsample, xyz, new_xyz)
            grouped = group_points(xyz, nidx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped = torch.cat([grouped, group_points(features, nidx)], -1)
        return new_xyz, self.mlps[0](grouped).amax(2)


class PointNet2Encoder(nn.Module):
    """Three set abstractions: (B, N, 3) -> (B, 1024)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128), g)
        self.sa2 = SetAbstraction(128, 0.4, 64, 3 + 128, (128, 128, 256), g)
        self.sa3 = SetAbstraction(None, None, None, 3 + 256, (256, 512, 1024), g)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        xyz = xyz[..., :3].contiguous()
        l1_xyz, l1 = self.sa1(xyz, None)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        return self.sa3(l2_xyz, l2)[1][:, 0]


class _PointNet2Cls(nn.Module):
    """The encoder under ``pointnetv2_encoder`` and the calling convention
    of the fine-tune models: ``model(pts (B, N, 3)) -> logits``; in
    training the draws come from ``draws`` or from ``generator``."""

    HEAD: Sequence[int] = ()

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pointnetv2_encoder = PointNet2Encoder(generator)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        """Draw a training forward's randomness from ``generator``."""
        return ClsDraws(sample_dropout_masks(batch, self.HEAD, _FinetuneHead.RATE,
                                             generator, device))


@MODELS.register_module()
class PointNetv2(_PointNet2Cls):
    """The encoder, then Dense 1024 -> 512, BatchNorm, ReLU, Dropout(0.5),
    Dense -> 256, BatchNorm, ReLU, Dropout(0.5), Dense -> ``cls_dim``."""

    HEAD = (512, 256)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls_head_finetune = _FinetuneHead(1024, self.HEAD,
                                               int(config.get("cls_dim", 40)), generator)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.pointnetv2_encoder(pts)
        if not self.training:
            return self.cls_head_finetune(feat)
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self.cls_head_finetune(feat, draws.dropout)


@MODELS.register_module()
class PointNetv2_Linear(_PointNet2Cls):
    """The encoder, then one ``cls`` Dense 1024 -> ``cls_dim``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls = Dense(1024, int(config.get("cls_dim", 40)), generator=generator)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cls(self.pointnetv2_encoder(pts))


@MODELS.register_module()
class PointNetv2_feat(_PointNet2Cls):
    """The SVM feature extractor: ``model(pts) -> (B, 1024)``."""

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.pointnetv2_encoder(pts)
