"""PointNet++ models (port of ``point_dae_tpu/models/dae_pointnet2.py``):
the set-abstraction encoder SA(512, r 0.2, k 32, [64, 64, 128]) -> SA(128,
r 0.4, k 64, [128, 128, 256]) -> SA(all, [256, 512, 1024]);
``FeaturePropagation`` (which no class uses); the DAEs
``Point_CAE_PointNetv2`` (the PCN decoder), ``_FCOnly`` (FC decoder) and
``_Proj`` (PCN after a 1024 -> 512 -> 1024 projection); the patch-wise
MA2E DAEs ``Point_MA2E_PointNetv2``, ``_local_only`` and ``_global_only``;
and the classes ``PointNetv2`` (the 512 / 256 head with BatchNorm and
dropout), ``PointNetv2_Linear`` (one ``cls`` Dense) and
``PointNetv2_feat`` (the 1024-wide feature). f32.

Torch names follow the reference's pointnet2 modules
(``pointnetv2_encoder.sa{j}.mlps.0.layer{i}.conv`` / ``.bn.bn``), its
decoders (``folding1``, ``folding2``, ``proj``, ``pos_embed``,
``coarse_pred``) and its ``cls_head_finetune`` Sequential. The head's two
dropout keep masks are inputs (``ClsDraws``), as for the transformer
fine-tune models; the DAEs' in-model dropouts take ``DropoutDraws``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.geometry import (ball_query, furthest_point_sample, gather_points, group_neighborhood,
                            group_points, three_interpolate, three_nn)
from ..utils.registry import MODELS
from .common import ClsDraws, DropoutDAE, DropoutDraws, folding_grid, sample_dropout_masks
from .layers import MLP, Dense, SharedMLP, SplitMLP, pcn_decode
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


class FeaturePropagation(nn.Module):
    """One FP level (pointnet2's ``PointnetFPModule``): the features of the
    ``xyz2`` points interpolated onto the ``xyz1`` points (broadcast where
    ``xyz2`` holds one point, else ``three_nn`` + ``three_interpolate``),
    after ``feat1`` where given, then the shared MLP (bias-free Dense +
    BatchNorm + ReLU a layer). Torch names ``mlp.layer{i}.conv`` and
    ``.bn.bn``. No model of either package uses it."""

    def __init__(self, din: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = SharedMLP(din, mlp, generator)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor, feat1: Optional[torch.Tensor],
                feat2: torch.Tensor) -> torch.Tensor:
        """xyz1 (B, N, 3), xyz2 (B, M, 3), feat1 (B, N, C1) or None, feat2
        (B, M, C2) -> (B, N, mlp[-1])."""
        if xyz2.shape[1] == 1:
            interp = feat2.expand(feat2.shape[0], xyz1.shape[1], feat2.shape[-1])
        else:
            dist, idx = three_nn(xyz1, xyz2)
            interp = three_interpolate(feat2, idx, dist)
        h = interp if feat1 is None else torch.cat([feat1, interp], -1)
        return self.mlp(h)


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


class _PN2Base(DropoutDAE):
    """The PointNet++ DAE skeleton: the configured in-model dropouts, then
    the encoder (``pointnetv2_encoder``)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config)
        self.pointnetv2_encoder = PointNet2Encoder(generator)

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """The global feature (B, 1024)."""
        return self.pointnetv2_encoder(pts)


@MODELS.register_module()
class Point_CAE_PointNetv2(_PN2Base):
    """The PCN decoder (``layers.pcn_decode``): 1024 coarse points, 16384
    fine ones. Returns (loss_coarse, loss_fine)."""
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
class Point_CAE_PointNetv2_Proj(Point_CAE_PointNetv2):
    """``Point_CAE_PointNetv2`` with a 1024 -> 512 -> 1024 projection
    between the encoder and the decoder."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.proj = MLP(1024, (512, 1024), generator=generator)

    def _project(self, feat: torch.Tensor) -> torch.Tensor:
        return self.proj(feat)


@MODELS.register_module()
class Point_CAE_PointNetv2_FCOnly(_PN2Base):
    """The FC decoder (``recfc``) to 1024 x 3. Returns (loss, 0)."""
    num_coarse = 1024

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.recfc = MLP(1024, (1024, 1024, self.num_coarse * 3), generator=generator)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        feat = self._encode_corrupted(corrupted, draws, generator)
        coarse = self.recfc(feat).reshape(-1, self.num_coarse, 3)
        loss = self.loss_func(coarse, clean[..., :3].contiguous())
        return loss, torch.zeros((), device=loss.device)


class _MA2EPN2Base(_PN2Base):
    """Patch-wise MA2E over the encoder: the clean cloud grouped into 64
    patches of 32 (``group_neighborhood``); a global head (``coarse_pred``)
    reconstructs the 64 centres; a local head folds a 6 x 6 grid (+-0.3) a
    patch from the global feature plus ``pos_embed(center)`` (3 -> 128 ->
    1024 with flax's default, tanh, GELU) through ``folding1`` and
    ``folding2``, scored against the patch's points. ``_heads`` runs the
    heads asked for; the other's loss is None."""
    num_coarse, group_size, grid_n = 64, 32, 6
    HEADS = (True, True)          # (local, global)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        g = generator
        self.pos_embed = MLP(3, (128, 1024), generator=g,
                             act=lambda: nn.GELU(approximate="tanh"))
        self.coarse_pred = MLP(1024, (1024, 1024, self.num_coarse * 3), generator=g)
        self.folding1 = SplitMLP(1024, 2, (512, 512, 3), generator=g)
        self.folding2 = SplitMLP(1024, 3, (512, 512, 3), generator=g)

    def _heads(self, corrupted, clean, draws, generator):
        neigh, center = group_neighborhood(clean[..., :3].contiguous(), self.num_coarse,
                                           self.group_size)
        feat = self._encode_corrupted(corrupted, draws, generator)
        B, (local, glob) = feat.shape[0], self.HEADS
        loss_fine = loss_coarse = None
        if glob:
            coarse = self.coarse_pred(feat).reshape(B, self.num_coarse, 3)
            loss_coarse = self.loss_func(coarse, center)
        if local:
            g2 = self.grid_n ** 2
            tok = feat[:, None, :] + self.pos_embed(center)          # (B, M, 1024)
            grid = torch.from_numpy(folding_grid((self.grid_n, self.grid_n))).to(feat.device)
            f1 = self.folding1(tok, grid.expand(B, self.num_coarse, g2, 2))
            rebuild = self.folding2(tok, f1).reshape(B * self.num_coarse, g2, 3)
            loss_fine = self.loss_func(rebuild, neigh.reshape(-1, self.group_size, 3))
        return loss_fine, loss_coarse


@MODELS.register_module()
class Point_MA2E_PointNetv2(_MA2EPN2Base):
    """Returns (loss_fine, loss_coarse)."""

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        return self._heads(corrupted, clean, draws, generator)


@MODELS.register_module()
class Point_MA2E_PointNetv2_local_only(_MA2EPN2Base):
    """The patch folding loss alone: returns (loss_fine, 0). The centre head
    does not run; its parameters get no gradient (zeros to AdamW, as the
    JAX package's are)."""
    HEADS = (True, False)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        loss = self._heads(corrupted, clean, draws, generator)[0]
        return loss, torch.zeros((), device=loss.device)


@MODELS.register_module()
class Point_MA2E_PointNetv2_global_only(_MA2EPN2Base):
    """The centre loss alone: returns (loss_coarse, 0). The folding head does
    not run (the patches are still grouped, for their centres)."""
    HEADS = (False, True)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Sequence[DropoutDraws]] = None,
                generator: Optional[torch.Generator] = None):
        loss = self._heads(corrupted, clean, draws, generator)[1]
        return loss, torch.zeros((), device=loss.device)
