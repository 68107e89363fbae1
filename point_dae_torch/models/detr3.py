"""The 3DETR-backbone DAE (port of ``point_dae_tpu/models/detr3.py:1-234``).

The pre-encoder groups the pipeline's corrupted cloud (FPS to G centres, a
ball of radius 0.2 and S points around each, xyz divided by the radius,
Dense + BatchNorm + ReLU at 64 / 128 / dim, max over the ball); the
encoder is 3DETR's pre-norm stack without positional embeddings (an
``nn.MultiheadAttention`` with biases, a 128-wide ReLU FFN, dropout 0.1, a
final LayerNorm) over the visible tokens; the targets are the clean
cloud's geometry at the pre-encoder's FPS indices: the centres for the
coarse head, the clean balls around them for the local head.

Random draws are inputs (``Detr3Draws``): the patch mask (or the block
mask's seed patches), the decoder's stochastic-depth keep masks and, for
each encoder layer, the four dropout keep masks. flax's attention dropout
draws one (T, T) mask a layer and shares it across every cloud and head
(``broadcast_dropout``); the residual and FFN dropouts are elementwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn as nn

from ..losses.chamfer import build_loss_func
from ..ops.geometry import ball_query, furthest_point_sample, gather_points, group_points
from ..utils.registry import MODELS
from .common import dropout_from_mask
from .layers import (MLP, Dense, LayerNorm, PosEmbedMLP, SharedMLP, lecun_normal_,
                     stack_dp_masks)
from .transformer import (ModelDraws, _CAETransformerBase, _take, masked_loss_fn,
                          sample_patch_mask, static_num_masked)

RADIUS = 0.2
DROPOUT = 0.1
FFN_DIM = 128


@dataclass
class DetrLayerDraws:
    """The keep masks of one encoder layer: ``attn`` (T, T), shared by every
    cloud and head; ``out1`` (B, T, C) after attention, ``ffn`` (B, T, F)
    inside the FFN, ``out2`` (B, T, C) after it."""
    attn: torch.Tensor
    out1: torch.Tensor
    ffn: torch.Tensor
    out2: torch.Tensor


@dataclass
class Detr3Draws(ModelDraws):
    """``ModelDraws`` plus the encoder's dropout keep masks, one
    ``DetrLayerDraws`` a layer (``dp_encoder`` is None: the encoder has no
    stochastic depth)."""
    enc_dropout: Optional[List[DetrLayerDraws]] = None


class DetrPreEncoder(nn.Module):
    """FPS to ``num_group`` centres, ``ball_query(0.2, group_size)``, the
    grouped xyz relative to the centre divided by the radius, the shared
    MLP 3 -> 64 -> 128 -> dim, max over the ball. Torch names
    ``mlp_module.layer{i}.conv`` / ``.bn.bn`` (3DETR's
    ``PointnetSAModuleVotes``)."""

    def __init__(self, num_group: int, group_size: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_group, self.group_size = num_group, group_size
        self.mlp_module = SharedMLP(3, (64, 128, dim), generator)

    def forward(self, pts: torch.Tensor):
        """pts (B, N, 3) -> (centres (B, G, 3), tokens (B, G, dim), FPS
        indices (B, G) int32)."""
        inds = furthest_point_sample(pts, self.num_group)
        new_xyz = gather_points(pts, inds)
        nidx = ball_query(RADIUS, self.group_size, pts, new_xyz)
        grouped = (group_points(pts, nidx) - new_xyz[:, :, None, :]) / RADIUS
        return new_xyz, self.mlp_module(grouped).amax(2), inds


class MultiheadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (biases, f32) under
    ``nn.MultiheadAttention``'s torch names: ``in_proj_weight`` (3 C, C),
    the query, key and value projections stacked; ``in_proj_bias``;
    ``out_proj``. The query is scaled by 1 / sqrt(head_dim) before the
    product, masked keys take the f32 minimum (not -inf), and the
    attention dropout multiplies the softmax by keep / 0.9."""

    def __init__(self, dim: int, num_heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(lecun_normal_(torch.empty(3 * dim, dim), dim,
                                                         generator))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        H = self.num_heads
        qkv = torch.matmul(x, self.in_proj_weight.t()) + self.in_proj_bias
        q, k, v = qkv.reshape(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q = q / torch.sqrt(torch.tensor(C // H, dtype=torch.float32))
        attn = torch.matmul(q, k.transpose(-1, -2))                 # (B, H, T, T)
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, None, :], attn,
                               torch.finfo(torch.float32).min)
        attn = torch.softmax(attn, dim=-1)
        if keep is not None:
            attn = attn * (keep.float() / torch.tensor(1.0 - DROPOUT))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(out)


class Detr3EncoderLayer(nn.Module):
    """3DETR's pre-norm layer: LN, attention, + dropout; LN, Dense(128),
    ReLU, dropout, Dense(dim), + dropout. Torch names ``self_attn``,
    ``linear1``, ``linear2``, ``norm1``, ``norm2``."""

    def __init__(self, dim: int, num_heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads, generator)
        self.norm2 = LayerNorm(dim)
        self.linear1 = Dense(dim, FFN_DIM, generator=generator)
        self.linear2 = Dense(FFN_DIM, dim, generator=generator)

    def forward(self, x, key_mask=None, drops: Optional[DetrLayerDraws] = None):
        drop = (lambda h, m: h) if drops is None else \
            (lambda h, m: dropout_from_mask(h, m, DROPOUT))
        h = self.self_attn(self.norm1(x), key_mask, None if drops is None else drops.attn)
        x = x + drop(h, None if drops is None else drops.out1)
        h = torch.relu(self.linear1(self.norm2(x)))
        h = self.linear2(drop(h, None if drops is None else drops.ffn))
        return x + drop(h, None if drops is None else drops.out2)


class DetrEncoder(nn.Module):
    """``depth`` layers and a final LayerNorm, no positional embedding.
    Torch names ``layers.{i}``, ``norm``."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(Detr3EncoderLayer(dim, num_heads, generator)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim)

    def forward(self, x, key_mask=None, drops: Optional[List[DetrLayerDraws]] = None):
        for i, layer in enumerate(self.layers):
            x = layer(x, key_mask, None if drops is None else drops[i])
        return self.norm(x)


@MODELS.register_module()
class PointCAE_transformer_fc_global_fc_local_3detr(_CAETransformerBase):
    """FC global head + FC local head over the 3DETR backbone. The coarse
    head ``MLP((512, 512, 3 G))`` on the max + mean of the visible tokens
    against the clean centres; the decoder over all G tokens (mask token at
    masked slots, the clean centres' position embedding); ``increase_dim``
    (dim -> 3 S) over the packed masked tokens against the clean balls, the
    masked chamfer. f32 but the decoder, which takes the compute dtype and
    ``residual_dtype``. With ``rand_ratio`` the visible tokens are packed
    visible-first to V = G - floor(0.5 G) slots under key masks. Calling
    convention: ``model(corrupted, clean, draws=None, generator=None) ->
    (loss_local, loss_global)``; ``corrupted`` feeds the encoder in
    training, ``clean`` the targets."""

    always_masked = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        t = self.tcfg
        C = int(t["trans_dim"])
        G, S = self.num_group, self.group_size
        g = generator
        self.pre_encoder = DetrPreEncoder(G, S, int(t["encoder_dims"]), g)
        self.blocks = DetrEncoder(C, int(t["depth"]), int(t["num_heads"]), g)
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = self._make_decoder(g)
        self.mask_token = self._make_mask_token(g)
        self.coarse_pred = MLP(C, (512, 512, 3 * G), generator=g)
        self.increase_dim = Dense(C, 3 * S, generator=g)
        self.loss = config.get("loss", "cdl2")
        self.global_loss_fn = build_loss_func(self.loss)

    def visible_capacity(self) -> int:
        """V: the encoder's token slots (G when nothing is masked
        statically)."""
        G = self.num_group
        return G - static_num_masked(0.5 if self.rand_ratio else self.mask_ratio, G)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> Detr3Draws:
        """Draw a forward's randomness from ``generator``."""
        mask = seed = None
        if self.mask_type == "block":
            seed = torch.randint(0, self.num_group, (batch,), generator=generator,
                                 device=device)
        else:
            mask = sample_patch_mask(batch, self.num_group, self.mask_ratio,
                                     self.rand_ratio, generator, device)
        V, C = self.visible_capacity(), int(self.tcfg["trans_dim"])
        keep = lambda *shape: torch.rand(shape, generator=generator,  # noqa: E731
                                         device=device) >= DROPOUT
        enc = [DetrLayerDraws(keep(V, V), keep(batch, V, C), keep(batch, V, FFN_DIM),
                              keep(batch, V, C)) for _ in self.blocks.layers]
        dp_dec = stack_dp_masks(self.MAE_decoder.dpr, batch, generator, device)
        return Detr3Draws(mask, None, None, dp_dec, seed, enc)

    def _encode_3detr(self, pts: torch.Tensor, draws: Detr3Draws):
        """(tokens (B, G, C) with zeros at masked slots, mask, centres, FPS
        indices)."""
        center, tokens, inds = self.pre_encoder(pts)
        B, G = tokens.shape[:2]
        mask = self.patch_mask(draws, center)
        drops = draws.enc_dropout if self.training else None
        V = self.visible_capacity()
        if V >= G:
            return self.blocks(tokens, ~mask, drops), mask, center, inds
        order = torch.sort(mask.to(torch.uint8), dim=-1, stable=True).indices
        vis_idx = order[:, :V]                                       # visible first
        num_vis = (~mask).sum(-1)
        slot_valid = torch.arange(V, device=mask.device)[None, :] < num_vis[:, None]
        x = self.blocks(_take(tokens, vis_idx), slot_valid, drops)
        x = torch.where(slot_valid[..., None], x, torch.zeros((), device=x.device))
        full = torch.zeros((B, G, x.shape[-1]), dtype=x.dtype, device=x.device)
        return full.scatter(1, vis_idx.long()[..., None].expand_as(x), x), mask, center, inds

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[Detr3Draws] = None,
                generator: Optional[torch.Generator] = None):
        pts = clean[..., :3]
        B, S = pts.shape[0], self.group_size
        if draws is None:
            draws = self.sample_draws(B, generator, pts.device)
        src = corrupted[..., :3] if self.training else pts
        x_vis, mask, _, inds = self._encode_3detr(src.contiguous(), draws)

        center_real = gather_points(pts, inds)
        nidx = ball_query(RADIUS, S, pts, center_real)
        gt = (group_points(pts.contiguous(), nidx) - center_real[:, :, None, :]) / RADIUS

        coarse = self.coarse_pred(self._global_feature(x_vis, mask)).reshape(B, -1, 3)
        loss2 = self.global_loss_fn(coarse, center_real)

        dp_dec = draws.dp_decoder if self.training else None
        x_rec = self._decode(x_vis, mask, center_real, dp_dec)
        w, x_m, gt_m = self._pack_local(mask, x_rec, gt)
        rebuild = self.increase_dim(x_m).float().reshape(-1, S, 3)
        loss1 = masked_loss_fn(self.loss)(rebuild, gt_m.reshape(-1, S, 3), w)
        return loss1, loss2

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """The SVM probe's feature: max + mean of the encoder over every
        token, no dropout. pts (B, N, >= 3) -> (B, C)."""
        _, tokens, _ = self.pre_encoder(pts[..., :3].contiguous())
        x = self.blocks(tokens)
        return x.amax(1) + x.mean(1)


@MODELS.register_module()
class PointCAE_transformer_fc_global_fc_local_3detr_encodernope(
        PointCAE_transformer_fc_global_fc_local_3detr):
    """Registered alias: the reference's class body is the base class's
    (the encoder has no positional embedding in both)."""
