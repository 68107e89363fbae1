"""The Point-M2AE family: a hierarchical masked autoencoder over a pyramid
of FPS + kNN groupings (port of ``point_dae_tpu/models/m2ae.py``).

The pyramid (e.g. 512 x 16 -> 256 x 8 -> 64 x 8 of 2048 points) groups
each scale's centres from the previous scale's; the mask is drawn at the
coarsest scale and back-propagated (a finer token is visible iff it
belongs to a visible coarse group). Each encoder scale token-merges the
previous scale's features through the kNN indices; the coarsest stage is
packed visible-first to V = G - floor(ratio G) slots, the finer stages
stay in place with the back-propagated visibility as their key mask, and
their masked slots carry the raw embedding onward. The decoder walks back
down with a mask token at the top and 3-NN feature propagation between
scales, and reconstructs the last decoded scale's masked patches.

As in the JAX package: every stage is f32 (plain attention and MLP), the
positional MLPs use the tanh GELU (flax's ``nn.gelu``) and ``TokenProp``
the exact one; ``local_radius`` is inert (the reference multiplies its
radius mask into the validity mask, which zeroes it); ``coarse_pred_i``
of the fc-center variants reads the reference's order (``coarse_pred_0``
is the coarsest scale's head). Calling conventions: the pretrain classes
``model(corrupted, clean, draws=None, generator=None) -> (loss, loss2)``
with an ``M2AEDraws`` or draws from ``generator``; ``Point_M2AE_SVMFeature``
``model(pts) -> (B, C)``; ``Point_M2AE_Finetune`` ``model(pts, draws=None,
generator=None) -> logits`` with a ``ClsDraws`` whose ``drop_path`` is a
list, one entry a stage.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.corruptions_patch import corrupt_patches_multi, sample_patch_multi_draws
from ..losses.chamfer import chamfer_l2, masked_chamfer_l2
from ..ops.geometry import (furthest_point_sample, gather_points, group_points, knn,
                            three_interpolate, three_nn)
from ..utils.registry import MODELS
from .common import ClsDraws, sample_dropout_masks
from .layers import (MLP, BatchNorm, Dense, LayerNorm, PatchEncoder, TransformerEncoder,
                     stack_dp_masks)
from .transformer import _FinetuneHead, _take, sample_patch_mask, static_num_masked


def pyramid_group(pts: torch.Tensor, num_groups: Sequence[int], group_sizes: Sequence[int]):
    """Multi-scale FPS + kNN pyramid: (neighbourhoods (B, G_i, S_i, 3)
    centred, centres (B, G_i, 3), kNN indices (B, G_i, S_i) into the
    previous scale's centres (the points at scale 0))."""
    neighborhoods, centers, idxs = [], [], []
    src = pts.contiguous()
    for G, S in zip(num_groups, group_sizes):
        center = gather_points(src, furthest_point_sample(src, int(G)))
        _, idx = knn(center, src, int(S))
        neighborhoods.append(group_points(src, idx) - center[:, :, None, :])
        centers.append(center)
        idxs.append(idx)
        src = center
    return neighborhoods, centers, idxs


def backprop_mask(vis_coarse: torch.Tensor, idx: torch.Tensor, g_fine: int) -> torch.Tensor:
    """(B, G_fine) bool: fine token j is visible iff it is a member (through
    ``idx`` (B, G_coarse, S)) of a visible coarse group (the scatter-max of
    ``m2ae.py:56-62``, as a count of visible memberships)."""
    B = vis_coarse.shape[0]
    member = vis_coarse[:, :, None].expand(idx.shape).reshape(B, -1).to(torch.int32)
    count = torch.zeros((B, g_fine), dtype=torch.int32, device=idx.device)
    return count.scatter_add_(1, idx.reshape(B, -1).long(), member) > 0


class PosMLP(nn.Sequential):
    """3 -> dim -> dim with flax's default (tanh) GELU between: the M2AE
    encoder's and decoder's positional MLPs. Torch names ``0`` and ``2``."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__(Dense(3, dim, generator=generator), nn.GELU(approximate="tanh"),
                         Dense(dim, dim, generator=generator))


def _dpr(rate: float, depths: Sequence[int]) -> List[List[float]]:
    """Each stage's slice of one 0 -> rate ramp over all its blocks."""
    total = sum(depths)
    flat = [rate * i / max(total - 1, 1) for i in range(total)]
    out, c = [], 0
    for d in depths:
        out.append(flat[c:c + d])
        c += d
    return out


class HEncoder(nn.Module):
    """Hierarchical encoder over the pyramid: per scale the token embedding
    (of the patches at scale 0, of the previous scale's features gathered
    by the kNN indices after), the positional MLP, a block stack and a
    LayerNorm. Torch names ``token_embed.{i}``, ``encoder_pos_embeds.{i}``,
    ``encoder_blocks.{i}.blocks.{j}``, ``encoder_norms.{i}``."""

    def __init__(self, dims: Sequence[int], depths: Sequence[int], num_heads: int,
                 drop_path_rate: float, mask_ratio: float, embed_all: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.mask_ratio = mask_ratio
        self.embed_all = embed_all
        ins = [3] + list(dims[:-1])
        # the reference's Token_Embed: the patch encoder's widths at scale 0,
        # BatchNorm over all B G S rows
        self.token_embed = nn.ModuleList(PatchEncoder(o, generator=g, in_channels=i)
                                         for i, o in zip(ins, dims))
        self.encoder_pos_embeds = nn.ModuleList(PosMLP(d, g) for d in dims)
        self.encoder_blocks = nn.ModuleList(
            TransformerEncoder(d, n, num_heads, generator=g, dpr=r)
            for d, n, r in zip(dims, depths, _dpr(drop_path_rate, depths)))
        self.encoder_norms = nn.ModuleList(LayerNorm(d) for d in dims)

    def forward(self, neighborhoods, centers, idxs, mask: Optional[torch.Tensor] = None,
                dp: Optional[Sequence[Optional[torch.Tensor]]] = None):
        """``mask`` (B, G_top) bool, True = masked, or None for no masking
        (``noaug``); ``dp``: one (depth, 2, B) keep mask (or None) a stage.
        Returns (per-scale normed features (B, G_i, C_i), zeros at the
        packed stage's masked slots; per-scale masks (B, G_i) bool)."""
        n = len(neighborhoods)
        B = neighborhoods[0].shape[0]
        dp = dp if dp is not None else [None] * n
        vis_list: List[Optional[torch.Tensor]] = [None] * n
        vis_list[-1] = torch.ones(centers[-1].shape[:2], dtype=torch.bool,
                                  device=centers[-1].device) if mask is None else ~mask
        for i in range(n - 1, 0, -1):
            vis_list[i - 1] = backprop_mask(vis_list[i], idxs[i], centers[i - 1].shape[1])

        feats, x_carry = [], None
        for i in range(n):
            embed_in = neighborhoods[i] if i == 0 else group_points(x_carry, idxs[i])
            G_i = centers[i].shape[1]
            V = G_i - static_num_masked(self.mask_ratio, G_i)
            embed, pos_mlp = self.token_embed[i], self.encoder_pos_embeds[i]
            stage, norm = self.encoder_blocks[i], self.encoder_norms[i]
            if i == n - 1 and mask is not None and V < G_i:
                vis = vis_list[i]
                vis_idx = torch.sort((~vis).to(torch.uint8), dim=-1, stable=True).indices[:, :V]
                if self.embed_all:
                    tokens = _take(embed(embed_in), vis_idx)
                else:
                    tokens = embed(_take(embed_in, vis_idx))
                pos = pos_mlp(_take(centers[i], vis_idx))
                slot_valid = (torch.arange(V, device=vis.device)[None, :]
                              < vis.sum(-1)[:, None])
                x = norm(stage(tokens, pos, slot_valid, dp[i]))
                x = torch.where(slot_valid[..., None], x, torch.zeros((), device=x.device))
                full = torch.zeros((B, G_i, x.shape[-1]), dtype=x.dtype, device=x.device)
                feats.append(full.scatter(1, vis_idx.long()[..., None].expand_as(x), x))
            else:
                tokens = embed(embed_in)
                x = stage(tokens, pos_mlp(centers[i]), vis_list[i], dp[i])
                # visible slots carry the encoded features on, masked ones
                # their raw embedding
                x_carry = torch.where(vis_list[i][..., None], x, tokens)
                feats.append(norm(x))
        return feats, [~v for v in vis_list]


class _Net(nn.Module):
    """``net``: Dense + BatchNorm (the reference's ConvBN block)."""

    def __init__(self, din: int, dout: int, generator):
        super().__init__()
        self.net = nn.Sequential(Dense(din, dout, generator=generator), BatchNorm(dout))

    def forward(self, x):
        return self.net(x)


class _ResUnit(nn.Module):
    """``net1`` (Dense, BatchNorm, then GELU) and ``net2`` (Dense,
    BatchNorm); the GELU on the residual sum is the caller's."""

    def __init__(self, dim: int, generator):
        super().__init__()
        self.net1 = nn.Sequential(Dense(dim, dim, generator=generator), BatchNorm(dim))
        self.net2 = nn.Sequential(Dense(dim, dim, generator=generator), BatchNorm(dim))


class _Extraction(nn.Module):
    def __init__(self, dim: int, blocks: int, generator):
        super().__init__()
        self.operation = nn.ModuleList(_ResUnit(dim, generator) for _ in range(blocks))


class TokenProp(nn.Module):
    """Token propagation between decoder scales (the reference's
    PointNetFeaturePropagation with kernel 1): a Dense + BatchNorm + GELU
    fuse, then ``blocks`` residual units, GELU exact throughout. Torch
    names ``fuse.net.{0,1}``, ``extraction.operation.{j}.net{1,2}.{0,1}``."""

    def __init__(self, din: int, dout: int, blocks: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fuse = _Net(din, dout, generator)
        self.extraction = _Extraction(dout, blocks, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fuse(x))
        for unit in self.extraction.operation:
            h = F.gelu(unit.net2(F.gelu(unit.net1(h))) + h)
        return h


@dataclass
class M2AEDraws:
    """Every random draw of one M2AE training forward: the coarsest
    scale's mask ((B, G_top) bool, True = masked), the list corruptions'
    draws (one entry a ``corrupt_type`` position, or None), and one
    stochastic-depth keep mask ((depth, 2, B) bool, or None) a stage of
    the encoder and of the decoder."""
    mask: Optional[torch.Tensor]
    corrupt: Optional[list]
    dp_encoder: Sequence[Optional[torch.Tensor]]
    dp_decoder: Sequence[Optional[torch.Tensor]] = ()


class _M2AEBase(nn.Module):
    """The pyramid and the hierarchical encoder (``h_encoder``) shared by
    the family."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.num_groups = [int(v) for v in c["num_groups"]]
        self.group_sizes = [int(v) for v in c["group_sizes"]]
        self.encoder_dims = [int(v) for v in c["encoder_dims"]]
        self.drop_path_rate = float(c.get("drop_path_rate", 0.1))
        self.mask_ratio = float(c.get("mask_ratio", 0.8))
        self.num_heads = int(c["num_heads"])
        self.h_encoder = HEncoder(self.encoder_dims, [int(v) for v in c["encoder_depths"]],
                                  self.num_heads, self.drop_path_rate, self.mask_ratio,
                                  embed_all=bool(c.get("embed_all_groups", False)),
                                  generator=generator)

    @property
    def scales(self) -> int:
        return len(self.num_groups)

    def _group(self, pts: torch.Tensor):
        return pyramid_group(pts[..., :3], self.num_groups, self.group_sizes)

    def _encoder_dp(self, batch: int, generator, device):
        return [stack_dp_masks(s.dpr, batch, generator, device)
                for s in self.h_encoder.encoder_blocks]

    def encode(self, pts: torch.Tensor, dp=None) -> torch.Tensor:
        """The SVM feature: mean + max over the coarsest scale's tokens of
        the encoder run without masking. pts (B, N, >= 3) -> (B, C)."""
        neighborhoods, centers, idxs = self._group(pts)
        feats, _ = self.h_encoder(neighborhoods, centers, idxs, None, dp)
        x = feats[-1]
        return x.mean(1) + x.amax(1)


class _M2AEDecoderBase(_M2AEBase):
    """The hierarchical decoder and the reconstruction at the last decoded
    scale: ``mask_token``, ``h_decoder.{i}.blocks.{j}``,
    ``decoder_pos_embeds.{i}``, ``token_prop.{i}``, ``decoder_norm``,
    ``rec_head``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        c, g = config, generator
        ddims = [int(v) for v in c["decoder_dims"]]
        ddepths = [int(v) for v in c["decoder_depths"]]
        up = [int(v) for v in c.get("decoder_up_blocks", [1] * (len(ddims) - 1))]
        self.decoder_dims = ddims
        self.mask_token = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, 1, ddims[0]), 0.0, 0.02, -0.04, 0.04, generator=g))
        self.h_decoder = nn.ModuleList(
            TransformerEncoder(d, n, self.num_heads, generator=g, dpr=r)
            for d, n, r in zip(ddims, ddepths, _dpr(self.drop_path_rate, ddepths)))
        self.decoder_pos_embeds = nn.ModuleList(PosMLP(d, g) for d in ddims)
        self.token_prop = nn.ModuleList(
            TokenProp(ddims[i] + ddims[i - 1], ddims[i], up[i - 1], g)
            for i in range(1, len(ddims)))
        self.decoder_norm = LayerNorm(ddims[-1])
        self.rec_head = Dense(ddims[-1], 3 * self.group_sizes[0], generator=g)

    def _sample_corrupt(self, batch: int, generator, device) -> Optional[list]:
        return None

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> M2AEDraws:
        """Draw a training forward's randomness from ``generator``."""
        mask = sample_patch_mask(batch, self.num_groups[-1], self.mask_ratio, False,
                                 generator, device)
        corrupt = self._sample_corrupt(batch, generator, device)
        return M2AEDraws(mask, corrupt, self._encoder_dp(batch, generator, device),
                         [stack_dp_masks(s.dpr, batch, generator, device)
                          for s in self.h_decoder])

    def _decode_and_rec(self, feats, masks, centers, neighborhoods, dp) -> torch.Tensor:
        """Coarse -> fine decoding (mask tokens at the top, 3-NN
        propagation between scales), then the masked chamfer-L2 of the last
        decoded scale's patches."""
        rc, rn = centers[::-1], neighborhoods[::-1]
        rf, rm = feats[::-1], masks[::-1]
        x_full = None
        for i in range(len(self.decoder_dims)):
            center = rc[i]
            vis = ~rm[i][..., None]
            if i == 0:
                x_full = torch.where(vis, rf[i], self.mask_token)
            else:
                x_en = torch.where(vis, rf[i], torch.zeros((), device=vis.device))
                dist, idx3 = three_nn(center, rc[i - 1])
                interp = three_interpolate(x_full, idx3, dist)
                x_full = self.token_prop[i - 1](torch.cat([x_en, interp], -1))
            x_full = self.h_decoder[i](x_full, self.decoder_pos_embeds[i](center), None,
                                       None if dp is None else dp[i])
        x_full = self.decoder_norm(x_full)
        last = len(self.decoder_dims) - 1
        B, G, _ = x_full.shape
        S = rn[last].shape[2]
        rec = self.rec_head(x_full).reshape(B * G, -1, 3)
        gt = rn[last].reshape(B * G, S, 3)
        return masked_chamfer_l2(rec, gt, rm[last].float().reshape(-1))

    def _run(self, pts, draws: Optional[M2AEDraws], generator):
        """(draws, pyramid) with the draws sampled when not given."""
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return draws, self._group(pts)


@MODELS.register_module()
class Point_M2AE(_M2AEDecoderBase):
    """Hierarchical MAE: returns (masked local reconstruction loss, 0).
    ``corrupted`` is unused, as in the reference; ``corrupt_type`` is
    read by no part of the model."""

    def forward(self, corrupted, clean, draws: Optional[M2AEDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        draws, (neighborhoods, centers, idxs) = self._run(clean, draws, generator)
        train = self.training
        feats, masks = self.h_encoder(neighborhoods, centers, idxs, draws.mask,
                                      draws.dp_encoder if train else None)
        loss = self._decode_and_rec(feats, masks, centers, neighborhoods,
                                    draws.dp_decoder if train else None)
        return loss, torch.zeros((), device=loss.device)


@MODELS.register_module()
class Point_MDAE_with_fc_center_p(_M2AEDecoderBase):
    """M2AE with one affine corruption of every pyramid scale at once
    (``corrupt_patches_multi`` of ``corrupt_type``, in training) and
    per-scale FC heads from the pooled visible features to the clean
    centres: returns (masked local reconstruction loss, the sum of the
    per-scale centre chamfers). The pooling runs over each cloud's true
    visible tokens, as in the JAX package."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.patch_corrupt_type = self._patch_corrupt_type(config)
        n = self.scales
        for i, (C, G) in enumerate(zip(self.encoder_dims, self.num_groups)):
            self.add_module(f"coarse_pred_{n - 1 - i}",
                            MLP(C, (1024, 1024, 3 * G), generator=generator))

    @staticmethod
    def _patch_corrupt_type(config):
        return tuple(config.get("corrupt_type", ()))

    def coarse_pred(self, i: int) -> MLP:
        """The centre head of scale i (finest 0)."""
        return getattr(self, f"coarse_pred_{self.scales - 1 - i}")

    def _sample_corrupt(self, batch: int, generator, device) -> Optional[list]:
        return sample_patch_multi_draws(self.patch_corrupt_type, batch, generator, device)

    def forward(self, corrupted, clean, draws: Optional[M2AEDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        draws, (neighborhoods, centers, idxs) = self._run(clean, draws, generator)
        train = self.training
        t_neighs = [nb + ctr[:, :, None, :] for nb, ctr in zip(neighborhoods, centers)]
        t_centers = list(centers)
        if train:
            t_neighs, t_centers = corrupt_patches_multi(t_neighs, t_centers,
                                                        self.patch_corrupt_type, draws.corrupt)
        t_neighs = [nb - ctr[:, :, None, :] for nb, ctr in zip(t_neighs, t_centers)]
        feats, masks = self.h_encoder(t_neighs, t_centers, idxs, draws.mask,
                                      draws.dp_encoder if train else None)
        loss_global = torch.zeros((), device=clean.device)
        for i in range(self.scales):
            vis = ~masks[i][..., None]
            x = feats[i]
            cnt = vis.sum(1).clamp_min(1).float()
            gfeat = (torch.where(vis, x, torch.full((), -1e9, device=x.device)).amax(1)
                     + torch.where(vis, x, 0.0).sum(1) / cnt)
            coarse = self.coarse_pred(i)(gfeat).reshape(gfeat.shape[0], -1, 3)
            loss_global = loss_global + chamfer_l2(coarse, centers[i])
        loss_local = self._decode_and_rec(feats, masks, centers, neighborhoods,
                                          draws.dp_decoder if train else None)
        return loss_local, loss_global


@MODELS.register_module()
class Point_M2AE_with_fc_center_p(Point_MDAE_with_fc_center_p):
    """``Point_MDAE_with_fc_center_p`` without the affine corruption."""

    @staticmethod
    def _patch_corrupt_type(config):
        return ()


@MODELS.register_module()
class Point_M2AE_with_fc_center_p_v1(Point_M2AE_with_fc_center_p):
    """The v1 flavour: the same heads and losses, no corruption (the
    reference differs only in head widths)."""


@MODELS.register_module()
class Point_MDAE_with_fc_center_p_v1(Point_MDAE_with_fc_center_p):
    """The corrupted v1 flavour: ``Point_MDAE_with_fc_center_p``."""


@MODELS.register_module()
class Point_M2AE_SVMFeature(_M2AEBase):
    """Frozen-feature extractor: ``encode``."""

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.encode(pts)


@MODELS.register_module()
class Point_M2AE_Finetune(_M2AEBase):
    """Classification on the coarsest pooled feature: the encoder without
    masking, then ``_FinetuneHead`` (256, 256)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls_head_finetune = _FinetuneHead(self.encoder_dims[-1], (256, 256),
                                               int(config.get("cls_dim", 40)),
                                               generator=generator)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        """Draw a training forward's randomness from ``generator``: the
        head's dropout masks and one drop-path mask a stage."""
        return ClsDraws(sample_dropout_masks(batch, self.cls_head_finetune.dims,
                                             _FinetuneHead.RATE, generator, device),
                        self._encoder_dp(batch, generator, device))

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return self.cls_head_finetune(self.encode(pts))
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self.cls_head_finetune(self.encode(pts, draws.drop_path), draws.dropout)
