"""The flagship transformer Point-DAE (port of
``point_dae_tpu/models/transformer.py:47-231,234-427,457-573,601-645``, its
``reconstruct`` included), the other PointCAE heads of the paper's decoder
ablations (``:429-454,576-598,648-739,884-1139``: FC or folding local and
global heads, centres only, the whole cloud, coarse to fine, supervised),
the classification fine-tune models ``PointTransformer`` (``:742-801``),
``PointTransformerNoClassToken`` (``:804-837``) and the linear probe
``PointTransformer_LinearClassification`` (``:838-860``, also registered
as ``PointTransformerLinearClassification``, ``:1143-1144``), and the SVM
feature extractor ``PointTransformerNoClassTokenSVMFeature`` (``:864-883``).

Static-shape MAE design, as in the JAX package: the mask ratio is bounded
(U(0.5, 0.8) with ``rand_ratio``), so the visible tokens are packed into a
fixed V = G - floor(0.5 G) slots (padding slots are invalid attention keys
and are zeroed on the scatter back), and the local reconstruction packs the
masked tokens into M = floor(0.8 G) slots with zero-weight padding. Without
``Drop-Patch`` in ``corrupt_type`` the model runs unmasked: every token
goes through the encoder, no mask token, every patch enters the loss.

Random draws (patch mask, or the block mask's seed patch, patch
corruptions, stochastic-depth keep masks, a head's dropout keep masks) are
inputs: ``forward`` takes a ``ModelDraws`` or samples one from the given
``torch.Generator``.

Every PointCAE head but the flagship computes its own products in f32,
as the JAX heads do (their folding heads are built without a dtype, so
the fused folding kernel's bf16 gate stays shut); the encoder and decoder
run at the config's compute dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..data.corruptions_patch import corrupt_patches, sample_patch_draws
from ..losses.chamfer import (build_loss_func, chamfer_l2_coarse2fine, masked_chamfer_l1,
                              masked_chamfer_l2)
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


def sample_block_mask(centers: torch.Tensor, mask_ratio: float,
                      seed_idx: torch.Tensor) -> torch.Tensor:
    """Block masking (JAX ``transformer.py:85-101``): each cloud masks the
    floor(ratio * G) patch centres nearest its seed patch ``seed_idx``
    (B,), the seed included, nearer first and lower index first on ties.
    centers (B, G, 3) -> (B, G) bool, True = masked."""
    B, G, _ = centers.shape
    seed = _take(centers, seed_idx.reshape(B, 1))                # (B, 1, 3)
    d = ((centers - seed) ** 2).sum(-1)
    order = torch.argsort(d, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(G, device=centers.device).expand(B, -1))
    return rank < static_num_masked(mask_ratio, G)


@dataclass
class ModelDraws:
    """Every random draw of one training forward."""
    mask: Optional[torch.Tensor]             # (B, G) bool, True = masked; None unmasked
    corrupt: Optional[list]                  # patch corruptions, one entry a position
    dp_encoder: Optional[torch.Tensor]       # (depth, 2, B) bool keep masks
    dp_decoder: Optional[torch.Tensor]       # (decoder_depth, 2, B)
    block_seed: Optional[torch.Tensor] = None   # (B,) seed patches of mask_type block


@dataclass
class SupervisedDraws(ModelDraws):
    """``ModelDraws`` plus the supervised head's dropout keep masks, one
    (B, width) bool a Dropout, in order."""
    dropout: Optional[list] = None


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
        return self.noaug(neighborhood, center, dp_masks)

    def noaug(self, neighborhood, center, dp_masks=None):
        """The encoder over every patch, without masking (the JAX
        encoder's ``noaug``); a subclass's masked forward leaves it as is."""
        x = self.blocks(self.encoder(neighborhood), self.pos_embed(center), None, dp_masks)
        return self.norm(x)


class MaskTransformerEncoder(NormalTransformerEncoder):
    """Patch embed + masking + ViT encoder on the packed visible tokens.
    Returns the (B, G, C) all-G layout, zeros at masked slots. The visible
    capacity is V = G - floor(min_ratio * G), min_ratio 0.5 under
    ``rand_ratio`` and ``mask_ratio`` otherwise (always under
    ``mask_type: block``).
    ``embed_all`` embeds all G patches and then takes the visible rows, so
    that the PatchEncoder's BatchNorm statistics run over all G (the
    reference's dataflow); by default only the visible patches are
    embedded. Its parameters are ``NormalTransformerEncoder``'s; ``noaug``
    runs it without masking."""

    def __init__(self, trans_dim, depth, num_heads, encoder_dims, drop_path_rate,
                 mask_ratio, rand_ratio, dtype, generator, embed_all: bool = False,
                 residual_dtype=None, remat: bool = False, mask_type: str = "rand"):
        super().__init__(trans_dim, depth, num_heads, encoder_dims, drop_path_rate,
                         dtype, generator, residual_dtype=residual_dtype, remat=remat)
        self.mask_ratio = mask_ratio
        self.rand_ratio = rand_ratio and mask_type != "block"
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
    rand`` or ``block`` (whose ratio is always ``mask_ratio``: ``rand_ratio``
    is a knob of the random mask only); the unmasked mode runs every token
    and has no mask token.

    The memory keys of ``transformer_config``, read as the JAX package reads
    them: ``residual_dtype: bf16`` (the stacks' residual stream in bf16),
    ``remat`` (the encoder's blocks recomputed in the backward),
    ``embed_all_patches`` and ``remat_fold`` (the flagship's folding head
    recomputed in the backward). None of them adds a parameter."""

    always_masked = False          # masked whatever corrupt_type says (MaskFeat)
    corrupts_patches = False       # draws and applies corrupt_type's patch corruptions

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
        self.mask_type = str(t.get("mask_type", "rand"))
        if self.masked_mode and self.mask_type not in ("rand", "block"):
            raise NotImplementedError(f"mask_type {self.mask_type!r}")
        self.rand_ratio = (str(t.get("rand_ratio", "False")) == "True"
                           and self.mask_type != "block")
        self.mask_ratio = float(t.get("mask_ratio", 0.6))
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
            residual_dtype=self.residual_dtype, remat=self.remat, mask_type=self.mask_type)

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
        """The patch corruptions' draws (``corrupts_patches``), else None."""
        if not self.corrupts_patches:
            return None
        return sample_patch_draws(self.corrupt_type, batch, self.num_group,
                                  self.group_size, generator, device)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ModelDraws:
        """Draw a forward's randomness from ``generator`` (no patch mask
        when unmasked; the seed patches, not the mask, under ``mask_type:
        block``; no decoder keep masks for a model without a decoder)."""
        mask = seed = None
        if self.masked_mode and self.mask_type == "block":
            seed = torch.randint(0, self.num_group, (batch,), generator=generator,
                                 device=device)
        elif self.masked_mode:
            mask = sample_patch_mask(batch, self.num_group, self.mask_ratio,
                                     self.rand_ratio, generator, device)
        corrupt = self._sample_corrupt(batch, generator, device)
        dp_enc = stack_dp_masks(self.MAE_encoder.blocks.dpr, batch, generator, device)
        decoder = getattr(self, "MAE_decoder", None)
        dp_dec = None if decoder is None else stack_dp_masks(decoder.dpr, batch, generator,
                                                             device)
        return ModelDraws(mask, corrupt, dp_enc, dp_dec, seed)

    def patch_mask(self, draws: ModelDraws, center: torch.Tensor) -> torch.Tensor:
        """The (B, G) patch mask of a forward: the drawn one, or under
        ``mask_type: block`` the block around each drawn seed patch of the
        centres the encoder sees."""
        if self.mask_type == "block":
            return sample_block_mask(center, self.mask_ratio, draws.block_seed)
        return draws.mask

    def _encode(self, t_neigh, t_center, draws: ModelDraws, dp_enc):
        """(tokens (B, G, C), mask (B, G) bool): all False when unmasked."""
        if self.masked_mode:
            mask = self.patch_mask(draws, t_center)
            return self.MAE_encoder(t_neigh, t_center, mask, dp_enc), mask
        x = self.MAE_encoder(t_neigh, t_center, dp_enc)
        return x, torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)

    def _encode_clean(self, clean: torch.Tensor, draws: Optional[ModelDraws],
                      generator: Optional[torch.Generator]):
        """Group the clean points, corrupt the patches (in training, with
        ``corrupts_patches``), encode: (neigh, center, x_vis, mask, draws),
        the draws sampled from ``generator`` when None."""
        pts = clean[..., :3]
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        neigh, center = group_neighborhood(pts, self.num_group, self.group_size)
        t_neigh, t_center = neigh + center[:, :, None, :], center
        if self.training and self.corrupts_patches:
            t_neigh, t_center = corrupt_patches(t_neigh, t_center, self.corrupt_type,
                                                draws.corrupt)
        t_neigh = t_neigh - t_center[:, :, None, :]
        dp_enc = draws.dp_encoder if self.training else None
        x_vis, mask = self._encode(t_neigh, t_center, draws, dp_enc)
        return neigh, center, x_vis, mask, draws

    def _run(self, clean: torch.Tensor, draws: Optional[ModelDraws],
             generator: Optional[torch.Generator]):
        """``_encode_clean``, then decode all G tokens: (neigh, center,
        x_vis, x_rec, mask)."""
        neigh, center, x_vis, mask, draws = self._encode_clean(clean, draws, generator)
        dp_dec = draws.dp_decoder if self.training else None
        return neigh, center, x_vis, self._decode(x_vis, mask, center, dp_dec), mask

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

    @staticmethod
    def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """max over the visible tokens of x (B, G, C) alone."""
        return torch.where(~mask[..., None], x, torch.full((), -1e9, device=x.device)).amax(1)

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """Global feature for the SVM probes: max + mean over every token of
        the encoder run without masking. pts (B, N, >= 3) -> (B, C)."""
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        x = self.MAE_encoder.noaug(neigh, center)
        return x.amax(1) + x.mean(1)

    def _masked_pack_idx(self, mask: torch.Tensor):
        """(midx (B, M), w (B * M,) f32) packing the masked token slots first
        to the fixed capacity M = floor(max_ratio * G), padding slots with
        weight 0; or None when every token enters the loss (``all_patch``),
        when packing would not shrink anything or leave no slot, and when
        unmasked."""
        G = mask.shape[1]
        M = static_num_masked(0.8 if self.rand_ratio else self.mask_ratio, G)
        if not self.masked_mode or self.all_patch or not 0 < M < G:
            return None
        order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
        w = torch.arange(M, device=mask.device)[None, :] < mask.sum(-1)[:, None]
        return order[:, :M], w.float().reshape(-1)

    def _local_recon_inputs(self, x_rec, neigh, mask):
        """(tokens, GT patches, loss weights), packed to the masked-token
        capacity M = floor(max_ratio * G) when only masked patches count."""
        B, G, S = neigh.shape[:3]
        pack = self._masked_pack_idx(mask)
        if pack is None:
            return x_rec, neigh.reshape(B * G, S, 3), self._loss_weights(mask)
        midx, w = pack
        return _take(x_rec, midx), _take(neigh, midx).reshape(-1, S, 3), w

    def _pack_local(self, mask: torch.Tensor, *tensors: torch.Tensor):
        """(w, packed...): per-token tensors packed to the masked-token
        capacity, or left in place with the mask as weights."""
        pack = self._masked_pack_idx(mask)
        if pack is None:
            return (mask.float().reshape(-1),) + tensors
        midx, w = pack
        return (w,) + tuple(_take(a, midx) for a in tensors)


def fold_tokens(x: torch.Tensor, grid: torch.Tensor, folding1: SplitMLP,
                folding2: SplitMLP, dtype=None, fold_impl: str = "auto") -> torch.Tensor:
    """Two-stage folding of every token of x (B, M, C) over ``grid`` (n, 2):
    (B, M, n, 3) f32. At bf16 ``dtype`` on a CUDA tensor it runs as the
    ``fused_folding`` kernel (the gate of JAX ``transformer.py:531-535``,
    "on TPU" read as "on CUDA") unless ``fold_impl: xla``; else as the
    plain ``SplitMLP`` products in ``dtype`` (None: the input's)."""
    B, M, C = x.shape
    n = grid.shape[0]
    if (fold_impl != "xla" and dtype == torch.bfloat16
            and fold_supported(C, folding1[2].weight.shape[0], n)
            and x.device.type == "cuda"):
        return fused_folding(x, grid, stage_params(folding1), stage_params(folding2))
    gridb = grid.expand(B, M, n, 2).to(dtype or x.dtype)
    return folding2(x, folding1(x, gridb)).float()


class FoldingHead(nn.Module):
    """A folding head that is a submodule in the JAX tree (``global_fold``):
    JAX ``_FoldingLocalHead`` as ``fold_head_cls`` builds it without a
    dtype, two f32 ``SplitMLP`` stages (C + 2 -> F, F, 3 and C + 3 -> F, F,
    3) over the 6 x 6 grid, so the kernel's bf16 gate stays shut.
    ``remat`` recomputes it in the backward (``remat_fold``). The JAX
    converter has no rule for it: the torch names ``folding1.{0,2,4}`` and
    ``folding2.{0,2,4}`` under the head's name follow the flax path
    (``global_fold/folding1/dense0`` ...)."""

    def __init__(self, C: int, F: int, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.folding1 = SplitMLP(C, 2, (F, F, 3), generator=generator)
        self.folding2 = SplitMLP(C, 3, (F, F, 3), generator=generator)
        self.register_buffer("grid", torch.from_numpy(folding_grid((6, 6))),
                             persistent=False)

    def _fold(self, x: torch.Tensor) -> torch.Tensor:
        return fold_tokens(x, self.grid, self.folding1, self.folding2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, M, C) -> (B, M, 36, 3) f32."""
        return checkpointed(self._fold, x) if self.remat else self._fold(x)


class _PointCAEBase(_CAETransformerBase):
    """The PointCAE transformer heads (JAX ``transformer.py:429-1139``):
    patches corrupted by ``corrupt_type`` in training; the shared head
    builders. A local folding head is ``folding1`` and ``folding2`` at the
    model's top level (the reference's torch names, flax ``fold/...``),
    computed in ``fold_dtype``: the flagship's compute dtype, None (f32) for
    every other head, whose JAX fold is built without a dtype.
    ``fold_impl`` and ``remat_fold`` apply to every folding head."""

    corrupts_patches = True
    fold_dtype = None

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.fold_impl = str(self.tcfg.get("fold_impl", "auto"))
        self.remat_fold = str(self.tcfg.get("remat_fold", "False")) == "True"
        self.loss = config.get("loss", "cdl2")
        self.global_loss_fn = build_loss_func(self.loss)

    def _make_decoder_side(self, generator) -> None:
        """decoder_pos_embed, MAE_decoder and (masked) mask_token, in the
        JAX package's order of creation."""
        self.decoder_pos_embed = PosEmbedMLP(int(self.tcfg["trans_dim"]), generator=generator)
        self.MAE_decoder = self._make_decoder(generator)
        if self.masked_mode:
            self.mask_token = self._make_mask_token(generator)

    def _make_local_fold(self, generator) -> None:
        C = int(self.tcfg["trans_dim"])
        self.folding1 = SplitMLP(C, 2, (C, C, 3), dtype=self.fold_dtype, generator=generator)
        self.folding2 = SplitMLP(C, 3, (C, C, 3), dtype=self.fold_dtype, generator=generator)
        self.register_buffer("grid", torch.from_numpy(folding_grid((6, 6))),
                             persistent=False)

    def _make_global_fold(self, generator) -> FoldingHead:
        C = int(self.tcfg["trans_dim"])
        return FoldingHead(C, C, self.remat_fold, generator)

    @staticmethod
    def _make_fc(din: int, dout: int, generator) -> nn.Sequential:
        """An f32 Dense under the reference's Conv1d name (``increase_dim.0``)."""
        return nn.Sequential(Dense(din, dout, generator=generator))

    def _fold_fused(self, x_rec: torch.Tensor) -> torch.Tensor:
        """The fused branch of ``_fold``."""
        return fused_folding(x_rec, self.grid, stage_params(self.folding1),
                             stage_params(self.folding2))

    def _fold(self, x_rec: torch.Tensor) -> torch.Tensor:
        """The local two-stage folding over the 6x6 grid: (B, M, C) ->
        (B, M, 36, 3)."""
        return fold_tokens(x_rec, self.grid, self.folding1, self.folding2, self.fold_dtype,
                           self.fold_impl)

    def _fold_local(self, x_loc: torch.Tensor) -> torch.Tensor:
        """``_fold``, recomputed in the backward under ``remat_fold``."""
        return checkpointed(self._fold, x_loc) if self.remat_fold else self._fold(x_loc)

    def _local_loss(self, x_rec, neigh, mask, head) -> torch.Tensor:
        """The masked chamfer of ``head``'s patches (tokens (B, M, C) ->
        (B, M, ...)) against the centred patches that enter the loss."""
        x_loc, gt, w = self._local_recon_inputs(x_rec, neigh, mask)
        rebuild = head(x_loc).reshape(gt.shape[0], -1, 3)
        return masked_loss_fn(self.loss)(rebuild, gt, w)

    def _coarse(self, mlp: nn.Module, gfeat: torch.Tensor) -> torch.Tensor:
        return mlp(gfeat).float().reshape(gfeat.shape[0], -1, 3)

    def _global_fold_cloud(self, gfeat: torch.Tensor) -> torch.Tensor:
        """``global_fold`` over the pooled feature as one token: (B, 36, 3)."""
        return self.global_fold(gfeat[:, None, :])[:, 0]


@MODELS.register_module()
class PointCAE_transformer_fc_global_folding_local(_PointCAEBase):
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
        self.fold_dtype = self.compute_dtype
        C = int(self.tcfg["trans_dim"])
        g = generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_decoder_side(g)
        self.coarse_pred = MLP(C, (1024, 1024, 3 * 64), dtype=self.compute_dtype, generator=g)
        self._make_local_fold(g)

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        """(loss_xyz, loss_global). ``corrupted`` is unused by this model, as
        in the reference; the patches come from ``clean``."""
        del corrupted
        neigh, center, x_vis, x_rec, mask = self._run(clean, draws, generator)
        loss2 = self.global_loss_fn(
            self._coarse(self.coarse_pred, self._global_feature(x_vis, mask)), center)
        return self._local_loss(x_rec, neigh, mask, self._fold_local), loss2

    def reconstruct(self, clean: torch.Tensor, draws: Optional[ModelDraws] = None,
                    generator: Optional[torch.Generator] = None):
        """The visualization path (JAX ``transformer.py:636-645``): (coarse
        global cloud (B, 64, 3), every patch folded and moved to its centre
        (B, G, 36, 3), mask (B, G)). All G decoded tokens are folded, not
        only the masked ones; in eval mode no patch is corrupted."""
        _, center, x_vis, x_rec, mask = self._run(clean, draws, generator)
        coarse = self._coarse(self.coarse_pred, self._global_feature(x_vis, mask))
        return coarse, self._fold(x_rec) + center[:, :, None, :], mask


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


@MODELS.register_module()
class PointTransformerNoClassToken(nn.Module):
    """Classification fine-tune without a class token (``transformer.py:
    804-837``): patch embedding, the ViT encoder over the patch tokens, a
    final LayerNorm, max + mean pooling and ``_FinetuneHead`` (256, 256).
    f32. Calling convention as ``PointTransformer``'s."""

    HEAD = (256, 256)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.num_group, self.group_size = int(c["num_group"]), int(c["group_size"])
        C = int(c["trans_dim"])
        g = generator
        self.encoder = PatchEncoder(int(c["encoder_dims"]), generator=g)
        self.pos_embed = PosEmbedMLP(C, generator=g)
        self.blocks = TransformerEncoder(C, int(c["depth"]), int(c["num_heads"]),
                                         drop_path_rate=float(c.get("drop_path_rate", 0.1)),
                                         generator=g)
        self.norm = LayerNorm(C)
        if self.HEAD:
            self.cls_head_finetune = _FinetuneHead(C, self.HEAD, int(c["cls_dim"]),
                                                   generator=g)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> ClsDraws:
        """Draw a training forward's randomness from ``generator``."""
        return ClsDraws(
            sample_dropout_masks(batch, self.HEAD, _FinetuneHead.RATE, generator, device),
            stack_dp_masks(self.blocks.dpr, batch, generator, device))

    def encode(self, pts: torch.Tensor, drop_path: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """max + mean of the normed tokens: pts (B, N, >= 3) -> (B, C)."""
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        x = self.blocks(self.encoder(neigh), self.pos_embed(center), None, drop_path)
        x = self.norm(x)
        return x.amax(1) + x.mean(1)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return self.cls_head_finetune(self.encode(pts))
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self.cls_head_finetune(self.encode(pts, draws.drop_path), draws.dropout)


@MODELS.register_module()
class PointTransformer_LinearClassification(PointTransformerNoClassToken):
    """Linear probe on the no-class-token backbone (``transformer.py:
    838-860``): max + mean of the normed tokens, then one ``cls`` Dense.
    f32. Calling convention as ``PointTransformer``'s; its draws are the
    stochastic-depth keep masks only."""

    HEAD = ()

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.cls = Dense(int(config["trans_dim"]), int(config["cls_dim"]), generator=generator)

    def forward(self, pts: torch.Tensor, draws: Optional[ClsDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return self.cls(self.encode(pts))
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        return self.cls(self.encode(pts, draws.drop_path))


# the reference registry's spelling (no underscore)
MODELS.register_module("PointTransformerLinearClassification",
                       module=PointTransformer_LinearClassification)


@MODELS.register_module()
class PointTransformerNoClassTokenSVMFeature(PointTransformerNoClassToken):
    """SVM feature extractor on the same backbone, without the head
    (``transformer.py:864-883``): ``model(pts) -> (B, C)``."""

    HEAD = ()

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.encode(pts)


# ------------------------------------------- the PointCAE heads' ablations

@MODELS.register_module()
class PointCAE_transformer(_PointCAEBase):
    """FC local head (JAX ``transformer.py:429-454``): an f32 Dense from each
    decoded token to S points, the masked patch chamfer; no global loss."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_decoder_side(g)
        self.increase_dim = self._make_fc(C, 3 * self.group_size, g)

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        """(loss_xyz, 0); ``corrupted`` is unused, as in the reference."""
        del corrupted
        neigh, _, _, x_rec, mask = self._run(clean, draws, generator)
        return self._local_loss(x_rec, neigh, mask, self.increase_dim), x_rec.new_zeros(())


@MODELS.register_module()
class PointCAE_transformer_fc_global_fc_local(_PointCAEBase):
    """FC global + FC local heads (JAX ``transformer.py:648-681``): f32
    ``coarse_pred`` to 64 points (whatever G is) on the visible max + mean,
    chamfer against the centres; the FC local head."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_decoder_side(g)
        self.coarse_pred = MLP(C, (1024, 1024, 3 * 64), generator=g)
        self.increase_dim = self._make_fc(C, 3 * self.group_size, g)

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        neigh, center, x_vis, x_rec, mask = self._run(clean, draws, generator)
        loss2 = self.global_loss_fn(
            self._coarse(self.coarse_pred, self._global_feature(x_vis, mask)), center)
        return self._local_loss(x_rec, neigh, mask, self.increase_dim), loss2


@MODELS.register_module()
class PointCAE_transformer_folding(_PointCAEBase):
    """Folding local head alone (JAX ``transformer.py:576-598``), in f32."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        g = generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_decoder_side(g)
        self._make_local_fold(g)

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        neigh, _, _, x_rec, mask = self._run(clean, draws, generator)
        return self._local_loss(x_rec, neigh, mask, self._fold_local), x_rec.new_zeros(())


@MODELS.register_module()
class PointCAE_transformer_folding_global_folding_local(_PointCAEBase):
    """Folding global + folding local heads (JAX ``transformer.py:684-716``):
    ``global_fold`` folds the visible max + mean as one token into 36
    points, chamfer against the centres."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        g = generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_decoder_side(g)
        self.global_fold = self._make_global_fold(g)
        self._make_local_fold(g)

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        neigh, center, x_vis, x_rec, mask = self._run(clean, draws, generator)
        loss2 = self.global_loss_fn(
            self._global_fold_cloud(self._global_feature(x_vis, mask)), center)
        return self._local_loss(x_rec, neigh, mask, self._fold_local), loss2


@MODELS.register_module()
class PointCAE_transformer_folding_global_fc_local(_PointCAEBase):
    """Folding global + FC local heads (JAX ``transformer.py:1053-1087``)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_decoder_side(g)
        self.global_fold = self._make_global_fold(g)
        self.increase_dim = self._make_fc(C, 3 * self.group_size, g)

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        neigh, center, x_vis, x_rec, mask = self._run(clean, draws, generator)
        loss2 = self.global_loss_fn(
            self._global_fold_cloud(self._global_feature(x_vis, mask)), center)
        return self._local_loss(x_rec, neigh, mask, self.increase_dim), loss2


class _EncoderOnlyHead(_PointCAEBase):
    """A head on the encoder's pooled feature alone: no decoder, no mask
    token. ``forward`` returns (the head's chamfer, 0)."""

    def _cloud(self, x_vis: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _target(self, clean: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
        return center

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        _, center, x_vis, mask, _ = self._encode_clean(clean, draws, generator)
        loss = self.global_loss_fn(self._cloud(x_vis, mask), self._target(clean, center))
        return loss, loss.new_zeros(())


@MODELS.register_module()
class PointCAE_transformer_patch_center_only(_EncoderOnlyHead):
    """The patch centres from the visible max + mean (JAX
    ``transformer.py:719-739``): f32 ``coarse_pred`` to 64 points."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self.coarse_pred = MLP(C, (1024, 1024, 3 * 64), generator=g)

    def _cloud(self, x_vis, mask):
        return self._coarse(self.coarse_pred, self._global_feature(x_vis, mask))


@MODELS.register_module()
class PointCAE_transformer_fc_center(_EncoderOnlyHead):
    """The G patch centres from the visible max alone (JAX
    ``transformer.py:884-903``): f32 ``coarse_pred`` to 3 G."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self.coarse_pred = MLP(C, (1024, 1024, 3 * self.num_group), generator=g)

    def _cloud(self, x_vis, mask):
        return self._coarse(self.coarse_pred, self._masked_max(x_vis, mask))


@MODELS.register_module()
class PointCAE_transformer_fold_center(_EncoderOnlyHead):
    """The patch centres folded from the visible max (JAX
    ``transformer.py:906-925``): ``global_fold``'s 36 points."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        g = generator
        self.MAE_encoder = self._make_encoder(g)
        self.global_fold = self._make_global_fold(g)

    def _cloud(self, x_vis, mask):
        return self._global_fold_cloud(self._masked_max(x_vis, mask))


@MODELS.register_module()
class PointCAE_transformer_fc_all(_EncoderOnlyHead):
    """The whole clean cloud from the visible max (JAX
    ``transformer.py:969-988``): f32 ``coarse_pred`` to the model config's
    ``npoints`` (default 1024) points, chamfer against every clean point."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self.coarse_pred = MLP(C, (1024, 1024, 3 * int(config.get("npoints", 1024))),
                               generator=g)

    def _cloud(self, x_vis, mask):
        return self._coarse(self.coarse_pred, self._masked_max(x_vis, mask))

    def _target(self, clean, center):
        return clean[..., :3]


@MODELS.register_module()
class PointCAE_transformer_fold_all(_EncoderOnlyHead):
    """The whole clean cloud folded from the visible max (JAX
    ``transformer.py:991-1017``): two f32 ``SplitMLP`` stages of widths
    (1024, 1024, 3) over a fixed 32 x 32 grid. The JAX converter has no
    rule for them: the torch names ``folding1.{0,2,4}`` and
    ``folding2.{0,2,4}`` follow the flax paths ``folding1/dense0`` ... at
    the model's top level."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self.folding1 = SplitMLP(C, 2, (1024, 1024, 3), generator=g)
        self.folding2 = SplitMLP(C, 3, (1024, 1024, 3), generator=g)
        self.register_buffer("grid", torch.from_numpy(folding_grid((32, 32))),
                             persistent=False)

    def _cloud(self, x_vis, mask):
        gfeat = self._masked_max(x_vis, mask)
        f1 = self.folding1(gfeat, self.grid.expand(gfeat.shape[0], -1, -1))
        return self.folding2(gfeat, f1)

    def _target(self, clean, center):
        return clean[..., :3]


@MODELS.register_module()
class PointCAE_transformer_v6_corase2fine_transformer(_PointCAEBase):
    """Coarse to fine (JAX ``transformer.py:928-966``), unmasked only: the
    tokens through an f32 Dense to 1024 (``increase_dim``) and a max, f32
    ``coarse_pred`` to G centres; the decoder over the encoder's tokens
    with the predicted centres as its position embedding;
    ``increase_dim_fine`` (an f32 Dense to S points, named after its flax
    path: the JAX converter has no rule for it) gives each token's patch;
    ``chamfer_l2_coarse2fine`` returns (centre term, fine term). Under
    ``Drop-Patch`` it builds, but its forward raises, as the reference's
    does."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self._make_coarse_head(C, g)
        self._make_decoder_side(g)
        self.increase_dim_fine = Dense(C, 3 * self.group_size, generator=g)

    def _make_coarse_head(self, C: int, g) -> None:
        self.increase_dim = self._make_fc(C, 1024, g)
        self.coarse_pred = MLP(1024, (1024, 1024, 3 * self.num_group), generator=g)

    def _coarse_centres(self, x_vis: torch.Tensor) -> torch.Tensor:
        """(B, G, 3) f32 predicted centres from the tokens (B, G, C)."""
        return self._coarse(self.coarse_pred, self.increase_dim(x_vis).amax(1))

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        if self.masked_mode:
            raise NotImplementedError("the reference raises for Drop-Patch too (:2655)")
        neigh, center, x_vis, _, draws = self._encode_clean(clean, draws, generator)
        B, G = x_vis.shape[:2]
        coarse = self._coarse_centres(x_vis)
        dp_dec = draws.dp_decoder if self.training else None
        x_rec = self.MAE_decoder(x_vis, self.decoder_pos_embed(coarse), None, dp_dec)
        rebuild = self.increase_dim_fine(x_rec).reshape(B, G, self.group_size, 3)
        return chamfer_l2_coarse2fine(coarse, center, rebuild, neigh)


@MODELS.register_module()
class PointCAE_transformer_v6_folding_corase2fine_transformer(
        PointCAE_transformer_v6_corase2fine_transformer):
    """Coarse to fine with a folding coarse head (JAX
    ``transformer.py:1090-1139``): the tokens' plain max folds a sqrt(G) x
    sqrt(G) grid (G must be a square) through two f32 ``SplitMLP((C, C,
    3))`` stages into the G centres; the rest as the FC coarse head's. The
    stages sit at the model's top level under their flax names
    (``folding1/dense0`` ...; torch ``folding1.{0,2,4}``)."""

    def _make_coarse_head(self, C: int, g) -> None:
        side = int(round(self.num_group ** 0.5))
        if side * side != self.num_group:
            raise ValueError("v6_folding needs a square num_group")
        self.folding1 = SplitMLP(C, 2, (C, C, 3), generator=g)
        self.folding2 = SplitMLP(C, 3, (C, C, 3), generator=g)
        self.register_buffer("grid", torch.from_numpy(folding_grid((side, side))),
                             persistent=False)

    def _coarse_centres(self, x_vis: torch.Tensor) -> torch.Tensor:
        gfeat = x_vis.amax(1)
        f1 = self.folding1(gfeat, self.grid.expand(gfeat.shape[0], -1, -1))
        return self.folding2(gfeat, f1)


@MODELS.register_module()
class PointCAE_transformer_supervised(_PointCAEBase):
    """Supervised pretraining (JAX ``transformer.py:1020-1050``):
    ``_FinetuneHead((256, 256), transformer_config.cls_dim)`` (default 55)
    on the visible max + mean. ``model(corrupted, clean, labels)`` returns
    (the mean NLL of the labels under ``log_softmax``, 0), or without
    labels (logits, 0). In training its draws carry the head's two dropout
    keep masks (``SupervisedDraws``)."""

    is_supervised = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, g = int(self.tcfg["trans_dim"]), generator
        self.MAE_encoder = self._make_encoder(g)
        self.cls_head_finetune = _FinetuneHead(C, (256, 256), int(self.tcfg.get("cls_dim", 55)),
                                               generator=g)

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> SupervisedDraws:
        draws = super().sample_draws(batch, generator, device)
        return SupervisedDraws(**vars(draws), dropout=sample_dropout_masks(
            batch, self.cls_head_finetune.dims, _FinetuneHead.RATE, generator, device))

    def forward(self, corrupted, clean, labels: Optional[torch.Tensor] = None,
                draws: Optional[SupervisedDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        _, _, x_vis, mask, draws = self._encode_clean(clean, draws, generator)
        logits = self.cls_head_finetune(self._global_feature(x_vis, mask),
                                        draws.dropout if self.training else None)
        zero = logits.new_zeros(())
        if labels is None:
            return logits, zero
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(1, labels.long().reshape(-1, 1)).mean(), zero
