"""Masked-feature prediction (port of
``point_dae_tpu/models/maskfeat.py:30-150``): ``MaskFeat_transformer``
(and its registered names ``_pointmae`` and ``_supervised``) and
``MaskFeat_dgcnn``.

A masked transformer student predicts the L2-normalised features of its
masked patches; the loss is the mean over the masked patches of
||n(target) - n(prediction)||^2. The targets: for ``MaskFeat_transformer``
the token features of a frozen ``MaskTransformerEncoder`` teacher run
without masking (``noaug``) on the same patches; for ``MaskFeat_dgcnn``
the frozen DGCNN teacher's pointwise features of the whole cloud, grouped
by the same patch indices and max-pooled.

The teacher is part of the model (``teacher.*``), starts from the model's
random weights until a checkpoint is merged into it, runs in eval mode (its
BatchNorm on running statistics, no stochastic depth) whatever the model's
mode, and runs under ``torch.no_grad()`` (the JAX package's
``stop_gradient``), so its activations never enter autograd; the optimizer
leaves its parameters alone (``engine/train_state.py``). Random draws
(patch mask, stochastic depth) are inputs, a ``ModelDraws`` as for the
flagship model.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..losses.chamfer import global_ratio
from ..ops.geometry import (furthest_point_sample, gather_points, group_neighborhood,
                            group_points, knn)
from ..utils.registry import MODELS
from .dgcnn import DGCNNEncoder
from .layers import Dense, PosEmbedMLP
from .transformer import MaskTransformerEncoder, ModelDraws, _CAETransformerBase


def _nrm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def masked_feat_mse(pred: torch.Tensor, target: torch.Tensor, w: torch.Tensor
                    ) -> torch.Tensor:
    """Weighted mean over rows of ||n(target) - n(pred)||^2, both rows
    L2-normalised. pred, target (R, D), w (R,)."""
    per = ((_nrm(target) - _nrm(pred)) ** 2).sum(-1)
    return global_ratio((per * w).sum(), w.sum())


class _FrozenTeacher:
    """Keeps ``self.teacher`` in eval mode whatever the model's mode."""

    def train(self, mode: bool = True):
        super().train(mode)
        self.teacher.eval()                 # the frozen teacher never trains
        return self


@MODELS.register_module()
class MaskFeat_transformer(_FrozenTeacher, _CAETransformerBase):
    """Student: ``MaskTransformerEncoder`` + decoder over all G tokens +
    ``increase_dim`` (trans_dim -> trans_dim); teacher: a second
    ``MaskTransformerEncoder`` run without masking. Both encoders are f32
    (``maskfeat.py:50-59``); the decoder takes the compute dtype and
    ``residual_dtype``. The config's ``loss`` key is not read. Calling
    convention: ``model(corrupted, clean, draws=None, generator=None) ->
    (loss, zeros)``; ``corrupted`` is unused, as in the reference."""

    always_masked = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        t = self.tcfg
        C = int(t["trans_dim"])
        g = generator
        make = lambda: MaskTransformerEncoder(  # noqa: E731
            C, t["depth"], t["num_heads"], t["encoder_dims"], t.get("drop_path_rate", 0.1),
            self.mask_ratio, self.rand_ratio, None, g, mask_type=self.mask_type)
        self.MAE_encoder = make()
        self.teacher = make()
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = self._make_decoder(g)
        self.mask_token = self._make_mask_token(g)
        self.increase_dim = Dense(C, C, generator=g)
        self.teacher.eval()

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
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
        with torch.no_grad():
            target = self.teacher.noaug(neigh, center)
        w, x_loc, tgt = self._pack_local(mask, x_rec, target)
        pred = self.increase_dim(x_loc)                       # (B, M, C)
        loss = masked_feat_mse(pred.reshape(w.shape[0], -1),
                               tgt.reshape(w.shape[0], -1), w)
        return loss, torch.zeros((), device=loss.device)


# the reference's names for a Point-MAE teacher (``pointmae_config.ckpt``)
# and a supervised PointTransformer teacher: the same model, another
# checkpoint in the teacher
MODELS.register_module("MaskFeat_transformer_pointmae", module=MaskFeat_transformer)
MODELS.register_module("MaskFeat_transformer_supervised", module=MaskFeat_transformer)


@MODELS.register_module()
class MaskFeat_dgcnn(_FrozenTeacher, _CAETransformerBase):
    """Student: ``MaskTransformerEncoder`` + decoder over all G tokens +
    ``increase_dim`` (trans_dim -> 1024). The encoder is built as the JAX
    one is (``maskfeat.py:100-107``): f32, without the compute dtype or the
    memory keys, which reach only the decoder (``residual_dtype``). Teacher:
    the ``reference``
    ``DGCNNEncoder``, f32. The config's ``loss`` key is not read: the loss
    is always the masked feature MSE. Calling convention:
    ``model(corrupted, clean, draws=None, generator=None) -> (loss,
    zeros)``; ``corrupted`` is unused, as in the reference."""

    always_masked = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C = int(self.tcfg["trans_dim"])
        g = generator
        t = self.tcfg
        self.MAE_encoder = MaskTransformerEncoder(
            C, t["depth"], t["num_heads"], t["encoder_dims"], t.get("drop_path_rate", 0.1),
            self.mask_ratio, self.rand_ratio, None, g, mask_type=self.mask_type)
        self.teacher = DGCNNEncoder(impl="reference", generator=g)
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = self._make_decoder(g)
        self.mask_token = self._make_mask_token(g)
        self.increase_dim = Dense(C, 1024, generator=g)
        self.teacher.eval()

    def forward(self, corrupted: torch.Tensor, clean: torch.Tensor,
                draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        pts = clean[..., :3]
        B = pts.shape[0]
        if draws is None:
            draws = self.sample_draws(B, generator, pts.device)
        center = gather_points(pts, furthest_point_sample(pts, self.num_group))
        _, idx = knn(center, pts, self.group_size)
        neigh = group_points(pts, idx) - center[:, :, None, :]
        mask = self.patch_mask(draws, center)
        dp_enc = draws.dp_encoder if self.training else None
        dp_dec = draws.dp_decoder if self.training else None
        x_vis = self.MAE_encoder(neigh, center, mask, dp_enc)
        x_rec = self._decode(x_vis, mask, center, dp_dec)

        with torch.no_grad():
            _, pointwise = self.teacher(pts)                  # (B, N, 1024)
            patch_feat = group_points(pointwise, idx).amax(2)  # (B, G, 1024)

        w, x_loc, tgt = self._pack_local(mask, x_rec, patch_feat)
        pred = self.increase_dim(x_loc)                       # (B, M, 1024)
        loss = masked_feat_mse(pred.reshape(w.shape[0], -1),
                               tgt.reshape(w.shape[0], -1), w)
        return loss, torch.zeros((), device=loss.device)
