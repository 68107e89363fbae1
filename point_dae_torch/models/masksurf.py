"""The MaskSurf family: masked surfel reconstruction (port of
``point_dae_tpu/models/masksurf.py``).

A surfel cloud (B, N, 3 + A) is patchified on its xyz: the patches' xyz are
centred on their centres and their attributes (normals, and in the curve
variants curvature and position) are grouped as they are. The encoder
masks patches as the flagship's does; the decoder runs over all G tokens.
The heads predict points and normals (``MaskSurf``), 7-channel surfels
(the v2 family: point, normal, position |p . n|), 8-channel surfels (the
curve variants) or dVAE tokens (``MaskSurf_v2_token_dis``); the losses
pair the normals and further channels through the xyz chamfer's
correspondence.

As in the JAX package the encoder is built without the compute dtype or
the memory keys (f32 whatever the config says); only the decoder takes
``transformer_config.dtype`` and ``residual_dtype``. The v2 variants'
``coarse_pred`` exists for the checkpoint's sake where no loss reads it,
and is not run there (the optimizer gives it a zero gradient, as optax
does). Reference quirks are kept: ``_pack_local`` weighs by the mask under
``all_patch`` too, ``MaskSurf_v2_local_global_point`` returns 0 as its
second loss, ``MaskSurf_v2_local_point_curve``'s second term is the
position channel. Calling convention: ``model(corrupted, clean (B, N, >=
6), draws=None, generator=None) -> (loss_xyz, loss_normal)``; draws are a
``ModelDraws`` (patch mask, stochastic depth).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..losses.chamfer import (dis_normalized_l1, dis_normalized_l2, dis_normalized_l2_strict,
                              masked_chamfer_withnormal_idx, nn_distance, normalize,
                              take_points, weighted_mean)
from ..ops.geometry import fps_knn, group_points
from ..utils.registry import MODELS
from .dvae import DiscreteVAE
from .layers import MLP, Dense, PosEmbedMLP
from .transformer import MaskTransformerEncoder, ModelDraws, _CAETransformerBase


def _normal_dis_for(loss_type: str):
    return {"cdl2normal": dis_normalized_l2,
            "cdl2normall1": dis_normalized_l1,
            "cdl2normalstrict": dis_normalized_l2_strict}.get(loss_type, dis_normalized_l2)


def _stop_scaled(term: torch.Tensor, ref: torch.Tensor, floor: float) -> torch.Tensor:
    """term * sg(ref / max(term, floor)): the reference's detached inverse
    loss weights, normalised to ``ref``."""
    return term * (ref / term.clamp_min(floor)).detach()


class _MaskSurfBase(_CAETransformerBase):
    """Encoder, decoder, mask token and the surfel grouping shared by the
    family; each subclass adds its heads."""

    always_masked = True

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        t = self.tcfg
        C = int(t["trans_dim"])
        g = generator
        # masksurf.py:100-109: f32, no memory keys
        self.MAE_encoder = MaskTransformerEncoder(
            C, t["depth"], t["num_heads"], t["encoder_dims"], t.get("drop_path_rate", 0.1),
            self.mask_ratio, self.rand_ratio, None, g)
        self.decoder_pos_embed = PosEmbedMLP(C, generator=g)
        self.MAE_decoder = self._make_decoder(g)
        self.mask_token = self._make_mask_token(g)

    def _group_surfels(self, surfels: torch.Tensor, attrs: bool = True):
        """(B, N, 3 + A) -> (xyz patches centred (B, G, S, 3), attribute
        patches (B, G, S, A) or None without ``attrs``, centres (B, G, 3)).
        The JAX package also gathers the centres' own attributes, and
        token_dis's attribute patches, which no loss reads."""
        _, center, idx = fps_knn(surfels[..., :3], self.num_group, self.group_size)
        xyz = group_points(surfels[..., :3], idx) - center[:, :, None, :]
        return xyz, group_points(surfels[..., 3:], idx) if attrs else None, center

    def _run(self, surfels: torch.Tensor, draws: Optional[ModelDraws],
             generator: Optional[torch.Generator], attrs: bool = True):
        """Group, encode the visible patches, decode all G tokens:
        (xyz, attr, center, x_vis, x_rec, mask)."""
        B = surfels.shape[0]
        if draws is None:
            draws = self.sample_draws(B, generator, surfels.device)
        xyz, attr, center = self._group_surfels(surfels, attrs)
        dp_enc = draws.dp_encoder if self.training else None
        dp_dec = draws.dp_decoder if self.training else None
        x_vis = self.MAE_encoder(xyz, center, draws.mask, dp_enc)
        x_rec = self._decode(x_vis, draws.mask, center, dp_dec)
        return xyz, attr, center, x_vis, x_rec, draws.mask


@MODELS.register_module()
class MaskSurf(_MaskSurfBase):
    """Masked surfel reconstruction: an FC point head and an FC normal head,
    the with-normal chamfer on the masked patches."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C, S = int(self.tcfg["trans_dim"]), self.group_size
        self.increase_dim = Dense(C, 3 * S, generator=generator)
        self.increase_dim2 = Dense(C, 3 * S, generator=generator)
        self.normal_dis = _normal_dis_for(config.get("loss", "cdl2normal"))

    def _heads(self, clean, draws, generator):
        xyz, attr, center, _, x_rec, mask = self._run(clean, draws, generator)
        S = self.group_size
        w, x_loc, xyz_p, nrm_p, ctr_p = self._pack_local(mask, x_rec, xyz, attr[..., :3],
                                                         center)
        reb_p = self.increase_dim(x_loc).reshape(-1, S, 3)
        reb_n = self.increase_dim2(x_loc).reshape(-1, S, 3)
        gt_p, gt_n = xyz_p.reshape(-1, S, 3), nrm_p.reshape(-1, S, 3)
        lx, ln, _, _ = masked_chamfer_withnormal_idx(reb_p, gt_p, reb_n, gt_n, w,
                                                     self.normal_dis)
        return lx, ln, (w, reb_p, reb_n, gt_p, gt_n, ctr_p)

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        lx, ln, _ = self._heads(clean, draws, generator)
        return lx, ln


@MODELS.register_module()
class MaskSurf_estimated_position(MaskSurf):
    """``MaskSurf`` plus the plane-offset regression |p . n^| of the
    absolute points, added to the normal loss scaled by
    ``position_weight``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.position_weight = float(config.get("position_weight", 1.0))

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        lx, ln, (w, reb_p, reb_n, gt_p, gt_n, ctr_p) = self._heads(clean, draws, generator)
        cflat = ctr_p.reshape(-1, 1, 3)
        reb_pos = ((reb_p + cflat) * normalize(reb_n)).sum(-1).abs()
        gt_pos = ((gt_p + cflat) * normalize(gt_n)).sum(-1).abs()
        pos_loss = weighted_mean(((reb_pos - gt_pos) ** 2).mean(-1), w)
        return lx, ln + pos_loss * self.position_weight


class _SurfV2Base(_MaskSurfBase):
    """7-channel surfels: normal (3) and position |p . n| of the absolute
    point with the raw dataset normal; ``increase_dim`` predicts S surfels
    a token and ``coarse_pred`` 7 channels a patch centre."""

    CHANNELS = 7

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        C = int(self.tcfg["trans_dim"])
        ch = self.CHANNELS
        self.increase_dim = Dense(C, ch * self.group_size, generator=generator)
        self.coarse_pred = MLP(C, (1024, 1024, ch * self.num_group), generator=generator)

    def _local_losses(self, x_rec, xyz, attr, center, mask):
        """(loss_xyz, loss_normal, loss_position), each a masked mean; the
        position pairs through the xyz chamfer's indices, taken from the
        same call as the with-normal loss."""
        S = self.group_size
        w, x_loc, xyz_p, nrm_p, ctr_p = self._pack_local(mask, x_rec, xyz, attr[..., :3],
                                                         center)
        surfel = self.increase_dim(x_loc).reshape(-1, S, 7)
        reb_p, reb_n, reb_pos = surfel[..., :3], surfel[..., 3:6], surfel[..., 6].abs()
        gt_p, gt_n = xyz_p.reshape(-1, S, 3), nrm_p.reshape(-1, S, 3)
        gt_pos = ((gt_p + ctr_p.reshape(-1, 1, 3)) * gt_n).sum(-1).abs()
        lx, ln, i1, i2 = masked_chamfer_withnormal_idx(reb_p, gt_p, reb_n, gt_n, w,
                                                       dis_normalized_l2)
        p1 = ((reb_pos - take_points(gt_pos, i1)) ** 2).mean(-1)
        p2 = ((gt_pos - take_points(reb_pos, i2)) ** 2).mean(-1)
        return lx, ln, weighted_mean(p1 + p2, w)


@MODELS.register_module()
class MaskSurf_v2_local_global_point(_SurfV2Base):
    """Local surfel head and global coarse surfel head with the adaptive
    inverse-loss weight: loss_point = l_coarse_xyz * sg(l_xyz /
    l_coarse_xyz) + l_xyz; the second loss is 0 (the reference's surfel
    combination is commented out), so the normal and position channels get
    no gradient. The global head reads the pooled visible encoder
    feature."""

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, center, x_vis, x_rec, mask = self._run(clean, draws, generator)
        lx, _, _ = self._local_losses(x_rec, xyz, attr, center, mask)
        gfeat = self._global_feature(x_vis, mask)
        coarse = self.coarse_pred(gfeat).reshape(gfeat.shape[0], -1, 7)
        d1, d2, _, _ = nn_distance(coarse[..., :3], center)
        loss_cx = d1.mean() + d2.mean()
        return _stop_scaled(loss_cx, lx, 1e-12) + lx, torch.zeros((), device=lx.device)


@MODELS.register_module()
class MaskSurf_v2_local_point_only(_SurfV2Base):
    """The local xyz term only."""

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, center, _, x_rec, mask = self._run(clean, draws, generator)
        lx, _, _ = self._local_losses(x_rec, xyz, attr, center, mask)
        return lx, torch.zeros((), device=lx.device)


@MODELS.register_module()
class MaskSurf_v2_local_point_normal(_SurfV2Base):
    """The xyz and normal terms."""

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, center, _, x_rec, mask = self._run(clean, draws, generator)
        lx, ln, _ = self._local_losses(x_rec, xyz, attr, center, mask)
        return lx, ln


@MODELS.register_module()
class MaskSurf_v2_local_point_position(_SurfV2Base):
    """The xyz and position terms."""

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, center, _, x_rec, mask = self._run(clean, draws, generator)
        lx, _, lp = self._local_losses(x_rec, xyz, attr, center, mask)
        return lx, lp


@MODELS.register_module()
class MaskSurf_v2_local_point_normal_position(_SurfV2Base):
    """xyz, then normal + position * ``weight_dis_vs_normal``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        self.weight_dis_vs_normal = float(config.get("weight_dis_vs_normal", 1.0))

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, center, _, x_rec, mask = self._run(clean, draws, generator)
        lx, ln, lp = self._local_losses(x_rec, xyz, attr, center, mask)
        return lx, ln + lp * self.weight_dis_vs_normal


@MODELS.register_module()
class MaskSurf_v2_token_dis(_MaskSurfBase):
    """Masked token prediction against a frozen dVAE tokenizer: the frozen
    ``dvae_teacher`` (encoder, dgcnn_1, codebook: the parts its training
    path runs, as in the JAX tree) tokenizes every patch; the head predicts
    a distribution over its vocabulary; the loss is the cross-entropy on
    the masked patches (all patches with ``all_patch: 'True'``). The
    teacher runs in eval mode on its running statistics, without gradient,
    and the optimizer leaves it out by its name; load it with
    ``model.dvae_config.ckpt`` (``engine/pretrain.py``)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__(config, generator)
        dcfg = dict(config.get("dvae_config") or {})
        dcfg.setdefault("group_size", self.group_size)
        dcfg.setdefault("num_group", self.num_group)
        self.dvae_teacher = DiscreteVAE(dcfg, generator=generator, tokenizer_only=True)
        self.num_tokens = self.dvae_teacher.num_tokens
        self.increase_dim = Dense(int(self.tcfg["trans_dim"]), self.num_tokens,
                                  generator=generator)
        self.dvae_teacher.eval()

    def train(self, mode: bool = True) -> "MaskSurf_v2_token_dis":
        super().train(mode)
        self.dvae_teacher.eval()            # the frozen tokenizer never trains
        return self

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, _, center, _, x_rec, mask = self._run(clean, draws, generator, attrs=False)
        with torch.no_grad():
            labels = self.dvae_teacher.tokenize_groups(xyz, center).argmax(-1)   # (B, G)
        if self.all_patch:
            logits = self.increase_dim(x_rec)
            w = torch.ones(labels.numel(), device=labels.device)
        else:
            w, x_loc, lbl = self._pack_local(mask, x_rec, labels[..., None])
            logits = self.increase_dim(x_loc)
            labels = lbl[..., 0]
        logp = torch.log_softmax(logits.float(), -1)
        ce = -logp.gather(-1, labels[..., None].long())[..., 0]
        loss = weighted_mean(ce.reshape(-1), w)
        return loss, torch.zeros((), device=loss.device)


class _SurfCurveBase(_SurfV2Base):
    """8-channel surfels from (B, N, 7) clouds (xyz, normal, curvature):
    the position |p . n| of the raw normal is appended to every point, the
    attributes are normal (3), curvature and position, and the head
    predicts 8 channels a point (its curvature and position through
    abs)."""

    CHANNELS = 8

    def _curve_run(self, clean, draws, generator):
        pts = clean[..., :7]
        pos = (pts[..., :3] * pts[..., 3:6]).sum(-1, keepdim=True).abs()
        return self._run(torch.cat([pts, pos], -1), draws, generator)

    def _local_losses_curve(self, x_rec, xyz, attr, mask):
        """(loss_xyz, loss_normal, loss_curve, loss_position), each a masked
        mean; normal, curvature and position pair through the xyz chamfer's
        indices."""
        S = self.group_size
        w, x_loc, xyz_p, attr_p = self._pack_local(mask, x_rec, xyz, attr)
        surfel = self.increase_dim(x_loc).reshape(-1, S, 8)
        reb_p, reb_n = surfel[..., :3], surfel[..., 3:6]
        reb_c, reb_pos = surfel[..., 6].abs(), surfel[..., 7].abs()
        gt_p = xyz_p.reshape(-1, S, 3)
        gt_n = attr_p[..., :3].reshape(-1, S, 3)
        gt_c, gt_pos = attr_p[..., 3].reshape(-1, S), attr_p[..., 4].reshape(-1, S)
        lx, ln, i1, i2 = masked_chamfer_withnormal_idx(reb_p, gt_p, reb_n, gt_n, w,
                                                       dis_normalized_l2)

        def corr_mse(a, b):
            m1 = ((a - take_points(b, i1)) ** 2).mean(-1)
            m2 = ((b - take_points(a, i2)) ** 2).mean(-1)
            return weighted_mean(m1 + m2, w)

        return lx, ln, corr_mse(reb_c, gt_c), corr_mse(reb_pos, gt_pos)


@MODELS.register_module()
class MaskSurf_v2_local_point_normal_position_curve(_SurfCurveBase):
    """xyz, then 0.33 times the normal, curvature and position terms, each
    scaled by sg(l_xyz / term)."""

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, _, _, x_rec, mask = self._curve_run(clean, draws, generator)
        lx, ln, lc, lp = self._local_losses_curve(x_rec, xyz, attr, mask)
        surf = (_stop_scaled(ln, lx, 1e-8) + _stop_scaled(lc, lx, 1e-8)
                + _stop_scaled(lp, lx, 1e-8))
        return lx, surf * 0.33


@MODELS.register_module()
class MaskSurf_v2_local_point_curve(_SurfCurveBase):
    """xyz, then the position term scaled by sg(l_xyz / term): despite the
    name, the reference's second term is the position channel."""

    def forward(self, corrupted, clean, draws: Optional[ModelDraws] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        xyz, attr, _, _, x_rec, mask = self._curve_run(clean, draws, generator)
        lx, _, _, lp = self._local_losses_curve(x_rec, xyz, attr, mask)
        return lx, _stop_scaled(lp, lx, 1e-8)


# The reference's configs name a bare 'MaskSurf_v2' whose class is commented
# out upstream; the JAX package registers the headline v2 variant under it.
MODELS.register_module("MaskSurf_v2", module=MaskSurf_v2_local_global_point)
