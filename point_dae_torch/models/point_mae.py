"""The Point-MAE baselines (port of ``point_dae_tpu/models/point_mae.py:1-108``).

``Point_MAE`` groups the clean cloud (no patch corruption), masks, decodes
and reconstructs each masked patch with a Dense head to S * 3 points under
the masked chamfer; ``Point_MAE_folding`` folds a 6 x 6 grid instead. Both
run in f32 whatever ``transformer_config`` says of dtypes: the JAX models
build their encoder, decoder and head without the compute dtype or the
memory keys. The second loss is 0. Random draws (patch mask, or the block
mask's seed patches, stochastic-depth keep masks) are inputs, a
``ModelDraws`` as for the flagship model.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.geometry import group_neighborhood
from ..utils.registry import MODELS
from .common import folding_grid
from .layers import Dense, PosEmbedMLP, SplitMLP, TransformerDecoder
from .transformer import (MaskTransformerEncoder, ModelDraws, _CAETransformerBase,
                          masked_loss_fn)


class _PointMAEBase(_CAETransformerBase):
    """Encoder, decoder and mask token of both baselines; each adds its
    head (``_head``: packed masked tokens (B, M, C) -> (B * M, P, 3))."""

    always_masked = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        t = self.tcfg
        C = int(t["trans_dim"])
        g = generator
        dpr = t.get("drop_path_rate", 0.1)
        self.MAE_encoder = MaskTransformerEncoder(
            C, t["depth"], t["num_heads"], t["encoder_dims"], dpr, self.mask_ratio,
            self.rand_ratio, None, g, mask_type=self.mask_type)
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = TransformerDecoder(C, t["decoder_depth"], t["decoder_num_heads"],
                                              dpr, None, g)
        self.mask_token = self._make_mask_token(g)
        self.loss = config.get("loss", "cdl2")

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        """(loss_xyz, 0). ``corrupted`` is unused, as in the reference."""
        del corrupted
        pts = clean[..., :3]
        if draws is None:
            draws = self.sample_draws(pts.shape[0], generator, pts.device)
        neigh, center = group_neighborhood(pts, self.num_group, self.group_size)
        mask = self.patch_mask(draws, center)
        dp_enc = draws.dp_encoder if self.training else None
        dp_dec = draws.dp_decoder if self.training else None
        x_vis = self.MAE_encoder(neigh, center, mask, dp_enc)
        x_rec = self._decode(x_vis, mask, center, dp_dec)
        x_loc, gt, w = self._local_recon_inputs(x_rec, neigh, mask)
        rebuild = self._head(x_loc).reshape(gt.shape[0], -1, 3)
        return masked_loss_fn(self.loss)(rebuild, gt, w), torch.zeros((), device=pts.device)


@MODELS.register_module()
class Point_MAE(_PointMAEBase):
    """The FC head: ``increase_dim`` (dim -> 3 S)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.increase_dim = Dense(int(self.tcfg["trans_dim"]), 3 * self.group_size,
                                  generator=generator)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.increase_dim(x)


@MODELS.register_module()
class Point_MAE_folding(_PointMAEBase):
    """The folding head: two ``SplitMLP`` stages over the 6 x 6 grid
    (the flagship's head at f32, whose fused kernel needs bf16)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C = int(self.tcfg["trans_dim"])
        self.folding1 = SplitMLP(C, 2, (C, C, 3), generator=generator)
        self.folding2 = SplitMLP(C, 3, (C, C, 3), generator=generator)
        self.register_buffer("grid", torch.from_numpy(folding_grid((6, 6))),
                             persistent=False)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        B, M, _ = x.shape
        gridb = self.grid.expand(B, M, self.grid.shape[0], 2).to(x.dtype)
        return self.folding2(x, self.folding1(x, gridb))
