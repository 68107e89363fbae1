"""The flagship transformer Point-DAE (port of
``point_dae_tpu/models/transformer.py:47-82,103-231,234-427,457-573,601-634``)
and the classification fine-tune model ``PointTransformer`` (``:742-801``).

Static-shape MAE design, as in the JAX package: the mask ratio is bounded
(U(0.5, 0.8) with ``rand_ratio``), so the visible tokens are packed into a
fixed V = G - floor(0.5 G) slots (padding slots are invalid attention keys
and are zeroed on the scatter back), and the local reconstruction packs the
masked tokens into M = floor(0.8 G) slots with zero-weight padding. Without
``Drop-Patch`` in ``corrupt_type`` the model runs unmasked: every token
goes through the encoder, no mask token, every patch enters the loss.

Random draws (patch mask, patch corruptions, stochastic-depth keep masks)
are inputs: ``forward`` takes a ``ModelDraws`` or samples one from the
given ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..data.corruptions_patch import corrupt_patches, sample_patch_draws
from ..losses.chamfer import build_loss_func, masked_chamfer_l1, masked_chamfer_l2
from ..ops.folding import fused_folding, stage_params, supported as fold_supported
from ..ops.geometry import group_neighborhood
from ..utils.registry import MODELS
from .common import ClsDraws, dropout_from_mask, folding_grid, sample_dropout_masks
from .layers import (MLP, BatchNorm, Dense, PatchEncoder, PosEmbedMLP, SplitMLP,
                     TransformerDecoder, TransformerEncoder, LayerNorm, checkpointed,
                     stack_dp_masks)


def masked_loss_fn(loss_type: str):
    """The local reconstruction's weighted chamfer for ``loss``."""
    if loss_type == "cdl1":
        return masked_chamfer_l1
    if loss_type == "cdl2":
        return masked_chamfer_l2
    raise NotImplementedError(loss_type)


def static_num_masked(ratio: float, num_group: int) -> int:
    """floor(float32(ratio) * float32(G)): the masked-token count, in the
    same f32 arithmetic as the sampled one (a float64 floor disagrees for
    legal configs, e.g. ratio 0.53, G 100)."""
    return int(np.floor(np.float32(ratio) * np.float32(num_group)))


def sample_patch_mask(batch: int, num_group: int, mask_ratio: float,
                      rand_ratio: bool, generator: Optional[torch.Generator],
                      device) -> torch.Tensor:
    """(B, G) bool, True = masked: exactly floor(ratio * G) patches a cloud,
    ratio ~ U(0.5, 0.8) drawn once per call when ``rand_ratio``."""
    if rand_ratio:
        ratio = torch.rand((), generator=generator, device=device) * 0.3 + 0.5
        lo, hi = static_num_masked(0.5, num_group), static_num_masked(0.8, num_group)
    else:
        ratio = torch.tensor(np.float32(mask_ratio), device=device)
        lo = hi = static_num_masked(mask_ratio, num_group)
    num_mask = torch.floor(ratio * num_group).clamp(lo, hi)
    r = torch.rand((batch, num_group), generator=generator, device=device)
    order = torch.argsort(r, dim=-1)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(num_group, device=device).expand(batch, -1))
    return rank < num_mask


@dataclass
class ModelDraws:
    """Every random draw of one training forward."""
    mask: Optional[torch.Tensor]             # (B, G) bool, True = masked; None unmasked
    corrupt: Optional[list]                  # patch corruptions, one entry a position
    dp_encoder: Optional[torch.Tensor]       # (depth, 2, B) bool keep masks
    dp_decoder: Optional[torch.Tensor]       # (decoder_depth, 2, B)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(a, idx[..., None, ...], axis=1) for (B, K) idx."""
    view = idx.long().reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, view.expand(idx.shape + a.shape[2:]))


class NormalTransformerEncoder(nn.Module):
    """Patch embed + ViT encoder over every token + a final LayerNorm (JAX
    ``transformer.py:203-231``, the unmasked variant). Torch names
    ``encoder``, ``pos_embed``, ``blocks``, ``norm``; ``residual_dtype`` and
    ``remat`` go to the block stack."""

    def __init__(self, trans_dim, depth, num_heads, encoder_dims, drop_path_rate,
                 dtype, generator, residual_dtype=None, remat: bool = False):
        super().__init__()
        self.encoder = PatchEncoder(encoder_dims, dtype=dtype, generator=generator)
        self.pos_embed = PosEmbedMLP(trans_dim, generator=generator)
        self.blocks = TransformerEncoder(trans_dim, depth, num_heads,
                                         drop_path_rate=drop_path_rate,
                                         dtype=dtype, generator=generator,
                                         residual_dtype=residual_dtype, remat=remat)
        self.norm = LayerNorm(trans_dim)

    def forward(self, neighborhood, center, dp_masks=None):
        x = self.blocks(self.encoder(neighborhood), self.pos_embed(center), None, dp_masks)
        return self.norm(x)


class MaskTransformerEncoder(NormalTransformerEncoder):
    """Patch embed + random masking + ViT encoder on the packed visible
    tokens. Returns the (B, G, C) all-G layout, zeros at masked slots.
    ``embed_all`` embeds all G patches and then takes the visible rows, so
    that the PatchEncoder's BatchNorm statistics run over all G (the
    reference's dataflow); by default only the visible patches are
    embedded. Its parameters are ``NormalTransformerEncoder``'s, whose
    forward is the encoder without masking (``noaug``)."""

    def __init__(self, trans_dim, depth, num_heads, encoder_dims, drop_path_rate,
                 mask_ratio, rand_ratio, dtype, generator, embed_all: bool = False,
                 residual_dtype=None, remat: bool = False):
        super().__init__(trans_dim, depth, num_heads, encoder_dims, drop_path_rate,
                         dtype, generator, residual_dtype=residual_dtype, remat=remat)
        self.mask_ratio = mask_ratio
        self.rand_ratio = rand_ratio
        self.embed_all = embed_all

    def forward(self, neighborhood, center, mask, dp_masks=None):
        B, G = neighborhood.shape[:2]
        V = G - static_num_masked(0.5 if self.rand_ratio else self.mask_ratio, G)
        if V >= G:
            tokens = self.encoder(neighborhood)
            x = self.blocks(tokens, self.pos_embed(center), ~mask, dp_masks)
            return self.norm(x)
        order = torch.sort(mask.to(torch.uint8), dim=-1, stable=True).indices
        vis_idx = order[:, :V]                               # visible first
        if self.embed_all:
            tokens = _take(self.encoder(neighborhood), vis_idx)
        else:
            tokens = self.encoder(_take(neighborhood, vis_idx))
        pos = self.pos_embed(_take(center, vis_idx))
        num_vis = (~mask).sum(-1)
        slot_valid = torch.arange(V, device=mask.device)[None, :] < num_vis[:, None]
        x = self.norm(self.blocks(tokens, pos, slot_valid, dp_masks))
        x = torch.where(slot_valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
        full = torch.zeros((B, G, x.shape[-1]), dtype=x.dtype, device=x.device)
        return full.scatter(1, vis_idx.long()[..., None].expand_as(x), x)


class _CAETransformerBase(nn.Module):
    """Shared parts of the transformer DAEs (JAX ``transformer.py:234-428``):
    the config keys they read, the encoder, decoder and mask token (built by
    the subclass, in its order of parameter creation), the draws, the
    decoder pass over all G tokens, the loss weights and the packing of the
    masked tokens. Builds no loss function: each model has its own. The
    masked mode (``Drop-Patch`` in ``corrupt_type``) takes ``mask_type:
    rand`` only; the unmasked mode runs every token and has no mask token.

    The memory keys of ``transformer_config``, read as the JAX package reads
    them: ``residual_dtype: bf16`` (the stacks' residual stream in bf16),
    ``remat`` (the encoder's blocks recomputed in the backward),
    ``embed_all_patches`` and ``remat_fold`` (the flagship's folding head
    recomputed in the backward). None of them adds a parameter."""

    always_masked = False          # masked whatever corrupt_type says (MaskFeat)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        t = config["transformer_config"]
        self.tcfg = t
        dt = t.get("dtype", config.get("dtype"))
        self.compute_dtype = torch.bfloat16 if str(dt) in ("bf16", "bfloat16") else None
        self.corrupt_type = tuple(config.get("corrupt_type", ()))
        self.masked_mode = self.always_masked or "Drop-Patch" in self.corrupt_type
        self.num_group = int(config["num_group"])
        self.group_size = int(config["group_size"])
        self.all_patch = str(config.get("all_patch", "False")) == "True"
        self.rand_ratio = str(t.get("rand_ratio", "False")) == "True"
        self.mask_ratio = float(t.get("mask_ratio", 0.6))
        if self.masked_mode and t.get("mask_type", "rand") != "rand":
            raise NotImplementedError("only mask_type 'rand' is ported")
        rd = t.get("residual_dtype")
        self.residual_dtype = torch.bfloat16 if str(rd) in ("bf16", "bfloat16") else None
        self.remat = bool(t.get("remat", False))
        self.embed_all = bool(t.get("embed_all_patches", False))

    def _make_encoder(self, generator) -> NormalTransformerEncoder:
        t = self.tcfg
        if not self.masked_mode:
            return NormalTransformerEncoder(
                int(t["trans_dim"]), t["depth"], t["num_heads"], t["encoder_dims"],
                t.get("drop_path_rate", 0.1), self.compute_dtype, generator,
                residual_dtype=self.residual_dtype, remat=self.remat)
        return MaskTransformerEncoder(
            int(t["trans_dim"]), t["depth"], t["num_heads"], t["encoder_dims"],
            t.get("drop_path_rate", 0.1), self.mask_ratio, self.rand_ratio,
            self.compute_dtype, generator, embed_all=self.embed_all,
            residual_dtype=self.residual_dtype, remat=self.remat)

    def _make_decoder(self, generator) -> TransformerDecoder:
        t = self.tcfg
        return TransformerDecoder(int(t["trans_dim"]), t["decoder_depth"],
                                  t["decoder_num_heads"], t.get("drop_path_rate", 0.1),
                                  self.compute_dtype, generator,
                                  residual_dtype=self.residual_dtype)

    def _make_mask_token(self, generator) -> nn.Parameter:
        return nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, 1, int(self.tcfg["trans_dim"])), 0.0, 0.02, -0.04, 0.04,
            generator=generator))

    def _sample_corrupt(self, batch: int, generator, device) -> Optional[list]:
        """The patch corruptions' draws; the base model corrupts no patch."""
        return None

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ModelDraws:
        """Draw a forward's randomness from ``generator`` (no patch mask
        when unmasked)."""
        mask = sample_patch_mask(batch, self.num_group, self.mask_ratio,
                                 self.rand_ratio, generator, device) \
            if self.masked_mode else None
        corrupt = self._sample_corrupt(batch, generator, device)
        dp_enc = stack_dp_masks(self.MAE_encoder.blocks.dpr, batch, generator, device)
        dp_dec = stack_dp_masks(self.MAE_decoder.dpr, batch, generator, device)
        return ModelDraws(mask, corrupt, dp_enc, dp_dec)

    def _encode(self, t_neigh, t_center, draws: ModelDraws, dp_enc):
        """(tokens (B, G, C), mask (B, G) bool): all False when unmasked."""
        if self.masked_mode:
            return self.MAE_encoder(t_neigh, t_center, draws.mask, dp_enc), draws.mask
        x = self.MAE_encoder(t_neigh, t_center, dp_enc)
        return x, torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)

    def _decode(self, x_vis: torch.Tensor, mask: torch.Tensor, center: torch.Tensor,
                dp_dec: Optional[torch.Tensor]) -> torch.Tensor:
        """Swap masked slots for the mask token (masked mode), add the
        decoder's position embedding of the true centres, run the decoder
        over all G tokens."""
        x_full = torch.where(mask[..., None], self.mask_token, x_vis) \
            if self.masked_mode else x_vis
        return self.MAE_decoder(x_full, self.decoder_pos_embed(center), None, dp_dec)

    def _loss_weights(self, mask: torch.Tensor) -> torch.Tensor:
        """(B * G,) f32: the masked patches, or every patch (``all_patch``,
        or the unmasked mode)."""
        if not self.masked_mode or self.all_patch:
            return torch.ones(mask.numel(), device=mask.device)
        return mask.float().reshape(-1)

    def _global_feature(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """max + mean over the visible tokens of x (B, G, C): masked slots
        enter neither reduction."""
        vis = ~mask[..., None]
        neg = torch.where(vis, x, torch.full((), -1e9, device=x.device))
        cnt = vis.sum(1).clamp_min(1).float()
        return neg.amax(1) + torch.where(vis, x, 0.0).sum(1) / cnt

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """Global feature for the SVM probes: max + mean over every token of
        the encoder run without masking. pts (B, N, >= 3) -> (B, C)."""
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        x = NormalTransformerEncoder.forward(self.MAE_encoder, neigh, center)
        return x.amax(1) + x.mean(1)

    def _masked_pack_idx(self, mask: torch.Tensor):
        """(midx (B, M), w (B * M,) f32) packing the masked token slots first
        to the fixed capacity M = floor(max_ratio * G), padding slots with
        weight 0; or None when every token enters the loss (``all_patch``)
        or packing would not shrink anything, and when unmasked."""
        G = mask.shape[1]
        M = static_num_masked(0.8 if self.rand_ratio else self.mask_ratio, G)
        if not self.masked_mode or self.all_patch or M >= G:
            return None
        order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
        w = torch.arange(M, device=mask.device)[None, :] < mask.sum(-1)[:, None]
        return order[:, :M], w.float().reshape(-1)

    def _pack_local(self, mask: torch.Tensor, *tensors: torch.Tensor):
        """(w, packed...): per-token tensors packed to the masked-token
        capacity, or left in place with the mask as weights."""
        pack = self._masked_pack_idx(mask)
        if pack is None:
            return (mask.float().reshape(-1),) + tensors
        midx, w = pack
        return (w,) + tuple(_take(a, midx) for a in tensors)


@MODELS.register_module()
class PointCAE_transformer_fc_global_folding_local(_CAETransformerBase):
    """Flagship model: FC global-shape head on the pooled visible feature
    (chamfer against the patch centres) and a two-stage folding head on the
    decoded masked tokens (masked chamfer against the centred patches).

    Masked (``Drop-Patch`` in corrupt_type, ``mask_type: rand``) or
    unmasked (all G tokens through the encoder, no mask token). At bf16 compute on a CUDA tensor the folding head
    runs as the ``fused_folding`` kernel unless ``fold_impl: xla`` asks for
    the plain ``SplitMLP`` products; the parameters are the same either way.
    ``remat_fold: True`` recomputes the folding head in the backward, with
    either ``fold_impl``.
    """

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.fold_impl = str(self.tcfg.get("fold_impl", "auto"))
        self.remat_fold = str(self.tcfg.get("remat_fold", "False")) == "True"
        C = int(self.tcfg["trans_dim"])
        dtype = self.compute_dtype
        g = generator
        self.MAE_encoder = self._make_encoder(g)
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = self._make_decoder(g)
        if self.masked_mode:
            self.mask_token = self._make_mask_token(g)
        self.coarse_pred = MLP(C, (1024, 1024, 3 * 64), dtype=dtype, generator=g)
        self.folding1 = SplitMLP(C, 2, (C, C, 3), dtype=dtype, generator=g)
        self.folding2 = SplitMLP(C, 3, (C, C, 3), dtype=dtype, generator=g)
        self.register_buffer("grid", torch.from_numpy(folding_grid((6, 6))),
                             persistent=False)
        self.loss = config.get("loss", "cdl2")
        self.global_loss_fn = build_loss_func(self.loss)

    def _sample_corrupt(self, batch: int, generator, device) -> Optional[list]:
        return sample_patch_draws(self.corrupt_type, batch, self.num_group,
                                  self.group_size, generator, device)

    def _fold_fused(self, x_rec: torch.Tensor) -> torch.Tensor:
        """The fused branch of ``_fold``."""
        return fused_folding(x_rec, self.grid, stage_params(self.folding1),
                             stage_params(self.folding2))

    def _fold(self, x_rec: torch.Tensor) -> torch.Tensor:
        """Two-stage folding over the 6x6 grid: (B, M, C) -> (B, M, 36, 3)."""
        B, M, C = x_rec.shape
        n = self.grid.shape[0]
        # the gate of transformer.py:531-535, "on TPU" read as "on CUDA"
        if (self.fold_impl != "xla" and self.compute_dtype == torch.bfloat16
                and fold_supported(C, self.folding1[2].weight.shape[0], n)
                and x_rec.device.type == "cuda"):
            return self._fold_fused(x_rec)
        gridb = self.grid.expand(B, M, n, 2).to(self.compute_dtype or x_rec.dtype)
        f1 = self.folding1(x_rec, gridb)
        return self.folding2(x_rec, f1).float()

    def _local_recon_inputs(self, x_rec, neigh, mask):
        """(tokens, GT patches, loss weights), packed to the masked-token
        capacity M = floor(max_ratio * G) when only masked patches count."""
        B, G, S = neigh.shape[:3]
        pack = self._masked_pack_idx(mask)
        if pack is None:
            return x_rec, neigh.reshape(B * G, S, 3), self._loss_weights(mask)
        midx, w = pack
        return _take(x_rec, midx), _take(neigh, midx).reshape(-1, S, 3), w

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        """(loss_xyz, loss_global). ``corrupted`` is unused by this model, as
        in the reference; the patches come from ``clean``."""
        del corrupted
        pts = clean[..., :3]
        B = pts.shape[0]
        if draws is None:
            draws = self.sample_draws(B, generator, pts.device)
        neigh, center = group_neighborhood(pts, self.num_group, self.group_size)
        t_neigh, t_center = neigh + center[:, :, None, :], center
        if self.training:
            t_neigh, t_center = corrupt_patches(t_neigh, t_center, self.corrupt_type,
                                                draws.corrupt)
        t_neigh = t_neigh - t_center[:, :, None, :]
        dp_enc = draws.dp_encoder if self.training else None
        dp_dec = draws.dp_decoder if self.training else None
        x_vis, mask = self._encode(t_neigh, t_center, draws, dp_enc)

        gfeat = self._global_feature(x_vis, mask)
        coarse = self.coarse_pred(gfeat).float().reshape(B, -1, 3)
        loss2 = self.global_loss_fn(coarse, center)

        x_rec = self._decode(x_vis, mask, center, dp_dec)
        x_loc, gt, w = self._local_recon_inputs(x_rec, neigh, mask)
        fold = checkpointed(self._fold, x_loc) if self.remat_fold else self._fold(x_loc)
        rebuild = fold.reshape(gt.shape[0], -1, 3)
        loss1 = masked_loss_fn(self.loss)(rebuild, gt, w)
        return loss1, loss2


# ----------------------------------------------------------- finetune heads

class _FinetuneHead(nn.Sequential):
    """Dense + BatchNorm + ReLU + Dropout(0.5) twice, then the classifier
    (``transformer.py:744-757``). The torch names follow the reference's
    ``cls_head_finetune`` Sequential, whose Dense and BatchNorm layers sit at
    ``0, 1, 4, 5, 8``; the ReLU and Dropout entries hold no parameters, and
    the dropout keep masks come in as inputs."""

    RATE = 0.5

    def __init__(self, din: int, dims: Sequence[int], cls_dim: int,
                 generator: Optional[torch.Generator] = None):
        mods = []
        for d in dims:
            mods += [Dense(din, d, generator=generator), BatchNorm(d), nn.ReLU(),
                     nn.Dropout(self.RATE)]
            din = d
        mods.append(Dense(din, cls_dim, generator=generator))
        super().__init__(*mods)
        self.dims = tuple(dims)

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``keep``: one (B, width) keep mask a Dropout, or None (eval)."""
        for i in range(len(self.dims)):
            x = torch.relu(self[4 * i + 1](self[4 * i](x)))
            if keep is not None:
                x = dropout_from_mask(x, keep[i], self.RATE)
        return self[-1](x)


@MODELS.register_module()
class PointTransformer(nn.Module):
    """Classification fine-tune with a cls token and cls position
    (``transformer.py:760-801``): patch embedding, the ViT encoder over
    [cls, patch tokens], a final LayerNorm, and the head on the concat of
    the cls output and the max over the patch tokens. ``dtype: bf16`` (a
    model key) runs the patch embedding and the blocks at bf16 compute.
    Calling convention: ``model(pts (B, N, 3)) -> logits (B, cls_dim)``;
    in training the draws (head dropout, stochastic depth) come from
    ``draws`` or from ``generator``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        dt = c.get("dtype")
        self.compute_dtype = torch.bfloat16 if str(dt) in ("bf16", "bfloat16") else None
        self.num_group, self.group_size = int(c["num_group"]), int(c["group_size"])
        C = int(c["trans_dim"])
        g = generator
        self.encoder = PatchEncoder(int(c["encoder_dims"]), dtype=self.compute_dtype,
                                    generator=g)
        self.pos_embed = PosEmbedMLP(C, generator=g)
        self.cls_token = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, 1, C), 0.0, 0.02, -0.04, 0.04, generator=g))
        self.cls_pos = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, 1, C), 0.0, 0.02, -0.04, 0.04, generator=g))
        self.blocks = TransformerEncoder(C, int(c["depth"]), int(c["num_heads"]),
                                         drop_path_rate=float(c.get("drop_path_rate", 0.1)),
                                         dtype=self.compute_dtype, generator=g)
        self.norm = LayerNorm(C)
        self.cls_head_finetune = _FinetuneHead(2 * C, (512, 256), int(c["cls_dim"]),
                                               generator=g)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        """Draw a training forward's randomness from ``generator``."""
        return ClsDraws(
            sample_dropout_masks(batch, self.cls_head_finetune.dims,
                                 _FinetuneHead.RATE, generator, device),
            stack_dp_masks(self.blocks.dpr, batch, generator, device))

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        tokens = self.encoder(neigh)
        B, _, C = tokens.shape
        if not self.training:
            draws = None
        elif draws is None:
            draws = self.sample_draws(B, generator, pts.device)
        pos = torch.cat([self.cls_pos.expand(B, 1, C), self.pos_embed(center)], 1)
        x = torch.cat([self.cls_token.expand(B, 1, C), tokens], 1)
        x = self.norm(self.blocks(x, pos, None, None if draws is None else draws.drop_path))
        feat = torch.cat([x[:, 0], x[:, 1:].amax(1)], -1)
        return self.cls_head_finetune(feat, None if draws is None else draws.dropout)
