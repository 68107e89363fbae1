"""Point-MlMAE, the multi-level masked autoencoder (port of
``point_dae_tpu/models/mlmae.py``; reference models/Point_MlMAE.py:347-718).

The encoder returns the normed tokens after blocks 4, 8 and 12
(``FETCH_IDX``) besides the patch tokens; the decoder returns every
block's normed output. The point reconstruction of the last decoder block
is held to the masked patches by the masked chamfer; ``feat_loss`` adds
masked feature regressions of decoder levels onto the encoder's levels of
an unmasked teacher pass ('high3': decoder block 1 onto encoder block 12,
'high2': 2 onto 8, 'high1': 3 onto 4, 'high0': 4 onto the patch tokens).
The teacher pass shares the encoder's weights and runs in eval mode
without gradient: its BatchNorms read the running statistics (those the
student pass just moved) and leave them as they are.

The masked encoder packs the visible patches into the static capacity V
and scatters its outputs back to all G slots with zeros at the masked
ones; as in the JAX package, its PatchEncoder's BatchNorm statistics come
from the V packed patches only (an approximation of the reference, which
embeds all G). f32 throughout. Random draws (patch mask or block seeds,
stochastic-depth keep masks) are inputs, a ``ModelDraws``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..losses.chamfer import global_ratio, masked_chamfer_l2
from ..ops.geometry import group_neighborhood
from ..utils.registry import MODELS
from .common import ClsDraws, sample_dropout_masks
from .layers import Dense, PosEmbedMLP, TransformerDecoder, stack_dp_masks
from .transformer import (ModelDraws, NormalTransformerEncoder, _CAETransformerBase,
                          _FinetuneHead, _take, static_num_masked)

FETCH_IDX = (3, 7, 11)
# feat_loss name: (teacher level, None for the patch tokens; decoder block)
FEAT_TARGETS = {"high3": (2, 0), "high2": (1, 1), "high1": (0, 2), "high0": (None, 3)}


class MlEncoder(NormalTransformerEncoder):
    """Patch embedding, the ViT blocks and the final LayerNorm of
    ``NormalTransformerEncoder`` (its torch names), read out at each block
    of ``FETCH_IDX``. ``levels`` runs the unmasked form when ``mask`` is
    None, else the masked one: packed to the visible capacity V = G -
    floor(min_ratio G) (min_ratio 0.5 under ``rand_ratio``, else
    ``mask_ratio``), or all G tokens with the masked ones as invalid keys
    when V >= G."""

    def __init__(self, trans_dim, depth, num_heads, encoder_dims, drop_path_rate,
                 mask_ratio, rand_ratio, generator):
        super().__init__(trans_dim, depth, num_heads, encoder_dims, drop_path_rate, None,
                         generator)
        self.mask_ratio = mask_ratio
        self.rand_ratio = rand_ratio

    def _stack(self, x, pos, key_mask, dp_masks) -> List[torch.Tensor]:
        feats = []
        for i, blk in enumerate(self.blocks.blocks):
            x = blk(x + pos, key_mask, None if dp_masks is None else dp_masks[i])
            if i in FETCH_IDX:
                feats.append(self.norm(x))
        return feats

    def levels(self, neighborhood, center, mask: Optional[torch.Tensor] = None,
               dp_masks=None) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """(fetched levels, each (B, G, C); mask (B, G); patch tokens (B, G,
        C)), zeros at the masked slots in the packed form."""
        B, G = neighborhood.shape[:2]
        V = G - static_num_masked(0.5 if self.rand_ratio else self.mask_ratio, G)
        if mask is None or V >= G:
            tokens = self.encoder(neighborhood)
            key_mask = None if mask is None else ~mask
            feats = self._stack(tokens, self.pos_embed(center), key_mask, dp_masks)
            if mask is None:
                mask = torch.zeros((B, G), dtype=torch.bool, device=tokens.device)
            return feats, mask, tokens
        vis_idx = torch.sort(mask.to(torch.uint8), dim=-1, stable=True).indices[:, :V]
        tokens = self.encoder(_take(neighborhood, vis_idx))
        slot_valid = torch.arange(V, device=mask.device)[None, :] < (~mask).sum(-1)[:, None]

        def scatter(z):
            z = torch.where(slot_valid[..., None], z, torch.zeros((), dtype=z.dtype,
                                                                  device=z.device))
            full = torch.zeros((B, G, z.shape[-1]), dtype=z.dtype, device=z.device)
            return full.scatter(1, vis_idx.long()[..., None].expand_as(z), z)

        feats = self._stack(tokens, self.pos_embed(_take(center, vis_idx)), slot_valid,
                            dp_masks)
        return [scatter(f) for f in feats], mask, scatter(tokens)


class MlDecoder(TransformerDecoder):
    """``TransformerDecoder`` read out after every block (normed)."""

    def levels(self, x, pos, dp_masks=None) -> List[torch.Tensor]:
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x + pos, None, None if dp_masks is None else dp_masks[i])
            outs.append(self.norm(x))
        return outs


def _encoder(t, mask_ratio: float, rand_ratio: bool, generator) -> MlEncoder:
    return MlEncoder(int(t["trans_dim"]), int(t["depth"]), int(t["num_heads"]),
                     int(t["encoder_dims"]), t.get("drop_path_rate", 0.1), mask_ratio,
                     rand_ratio, generator)


@MODELS.register_module()
class Point_MlMAE(_CAETransformerBase):
    """The multi-level MAE pretrain model: ``model(corrupted, clean,
    draws=None, generator=None) -> (masked chamfer-L2 of the rebuilt masked
    patches, the summed feature losses of ``feat_loss``)``; ``corrupted``
    is unused. Neither ``loss`` nor ``all_patch`` is read: the chamfer is
    always L2 and every loss weighs the masked patches."""

    always_masked = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.all_patch = False
        t = self.tcfg
        C = int(t["trans_dim"])
        g = generator
        self.MAE_encoder = _encoder(t, self.mask_ratio, self.rand_ratio, g)
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = MlDecoder(C, int(t["decoder_depth"]), int(t["decoder_num_heads"]),
                                     t.get("drop_path_rate", 0.1), None, g)
        self.mask_token = self._make_mask_token(g)
        self.increase_dim = Dense(C, 3 * self.group_size, generator=g)
        self.feat_loss = tuple(config.get("feat_loss", ()))

    def _teacher(self, neigh, center):
        """The unmasked encoder in eval mode, without gradient: (levels,
        patch tokens)."""
        enc = self.MAE_encoder
        was = enc.training
        enc.eval()
        try:
            with torch.no_grad():
                feats, _, tokens = enc.levels(neigh, center)
        finally:
            enc.train(was)
        return feats, tokens

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        pts = clean[..., :3]
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        neigh, center = group_neighborhood(pts, self.num_group, self.group_size)
        mask = self.patch_mask(draws, center)
        dp_enc = draws.dp_encoder if self.training else None
        dp_dec = draws.dp_decoder if self.training else None
        feats, _, _ = self.MAE_encoder.levels(neigh, center, mask, dp_enc)
        t_feats, t_tokens = self._teacher(neigh, center)
        x_full = torch.where(mask[..., None], self.mask_token, feats[-1])
        outs = self.MAE_decoder.levels(x_full, self.decoder_pos_embed(center), dp_dec)
        x_loc, gt, w = self._local_recon_inputs(outs[-1], neigh, mask)
        rebuild = self.increase_dim(x_loc).reshape(gt.shape[0], -1, 3)
        loss1 = masked_chamfer_l2(rebuild, gt, w)
        wm = mask.float()[..., None]
        loss_feat = torch.zeros((), device=pts.device)
        for name, (lvl, dec_idx) in FEAT_TARGETS.items():
            if name in self.feat_loss and dec_idx < len(outs):
                tgt = t_tokens if lvl is None else t_feats[lvl]
                loss_feat = loss_feat + global_ratio((((tgt - outs[dec_idx]) ** 2) * wm).sum(),
                                                     wm.sum())
        return loss1, loss_feat

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """SVM-probe feature: max + mean of the last fetched level of the
        unmasked encoder."""
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        x = self.MAE_encoder.levels(neigh, center)[0][-1]
        return x.amax(1) + x.mean(1)


@MODELS.register_module()
class PointTransformerMlMAE(torch.nn.Module):
    """Classification fine-tune on the MlMAE encoder (Point_MlMAE.py:
    467-597): the unmasked encoder's last level pooled as concat(max, mean)
    -> ``_FinetuneHead`` (256, 256). The encoder keys come from
    ``transformer_config`` or the model config itself. Calling convention as
    ``PointTransformer``'s: ``model(pts, draws=None, generator=None) ->
    logits``; in training the draws are the head dropout's and the
    stochastic depth's keep masks (a ``ClsDraws``)."""

    HEAD = (256, 256)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        t = config["transformer_config"] if "transformer_config" in config else config
        self.num_group, self.group_size = int(config["num_group"]), int(config["group_size"])
        self.MAE_encoder = _encoder(t, 0.0, False, generator)
        C = int(t["trans_dim"])
        self._head(2 * C, int(config.get("cls_dim", 40)), generator)

    def _head(self, din: int, cls_dim: int, generator) -> None:
        self.cls_head_finetune = _FinetuneHead(din, self.HEAD, cls_dim, generator=generator)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        return ClsDraws(sample_dropout_masks(batch, self.HEAD, _FinetuneHead.RATE, generator,
                                             device),
                        stack_dp_masks(self.MAE_encoder.blocks.dpr, batch, generator, device))

    def encode(self, pts: torch.Tensor, drop_path: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """concat(max, mean) of the last level: (B, N, >= 3) -> (B, 2 C)."""
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        x = self.MAE_encoder.levels(neigh, center, None, drop_path)[0][-1]
        return torch.cat([x.amax(1), x.mean(1)], -1)

    def _classify(self, feat, draws: Optional[ClsDraws]):
        return self.cls_head_finetune(feat, None if draws is None else draws.dropout)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return self._classify(self.encode(pts), None)
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self._classify(self.encode(pts, draws.drop_path), draws)


@MODELS.register_module()
class PointTransformerMlMAELinearClassification(PointTransformerMlMAE):
    """The linear probe (Point_MlMAE.py:599-718): one ``cls`` Dense on the
    same feature."""

    HEAD = ()

    def _head(self, din: int, cls_dim: int, generator) -> None:
        self.cls = Dense(din, cls_dim, generator=generator)

    def _classify(self, feat, draws: Optional[ClsDraws]):
        return self.cls(feat)
