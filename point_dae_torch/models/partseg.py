"""Part-segmentation models (port of ``point_dae_tpu/models/partseg.py``):
``PointTransformerPartSeg``, ``DGCNNPartSeg`` and ``PointNetNoTPartSeg``,
with the NLL loss and ``SegDraws``, every random draw of one train step.

Calling convention: ``model(pts (B, N, 3), cls_label (B, 16) one-hot,
draws=None, generator=None) -> log-probs (B, N, parts)``. In training the
stochastic-depth and dropout keep masks come from ``draws`` (or are drawn
from ``generator``); in eval they are not used. Everything runs in f32, as
the JAX models do (they take no ``dtype``). Torch names follow the
reference's segmentation models; ``utils/convert.py`` maps them to the flax
names.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import group_neighborhood, three_interpolate, three_nn
from ..utils.registry import MODELS
from .common import dropout_from_mask, sample_dropout_masks
from .dgcnn import DGCNNPartSegEncoder, _Conv
from .layers import (BatchNorm, Dense, LayerNorm, PatchEncoder, PosEmbedMLP, SplitDense,
                     TransformerEncoder, leaky_relu02, stack_dp_masks)

N_CATEGORIES = 16       # ShapeNetPart object categories (the one-hot label)
DROPOUT_RATE = 0.5


@dataclass
class SegDraws:
    """Every random draw of one part-segmentation train step:

    - ``scale`` (B, 1, 1) ~ U(0.8, 1.25) and ``shift`` (B, 1, 3) ~
      U(-0.1, 0.1), the step's isotropic scale and shift of the clouds;
    - ``drop_path``: the stochastic-depth keep masks (depth, 2, B) bool, or
      None for a model without them;
    - ``dropout``: one (B, N, width) bool keep mask a Dropout of the head,
      in order."""
    scale: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None
    drop_path: Optional[torch.Tensor] = None
    dropout: Sequence[torch.Tensor] = field(default_factory=tuple)

    @classmethod
    def sample(cls, model: nn.Module, batch: int, n_points: int,
               generator: Optional[torch.Generator], device) -> "SegDraws":
        """Draw, in this order, scale, shift, the model's stochastic-depth
        masks and its dropout masks from ``generator``."""
        scale = 0.8 + 0.45 * torch.rand((batch, 1, 1), generator=generator, device=device)
        shift = -0.1 + 0.2 * torch.rand((batch, 1, 3), generator=generator, device=device)
        dpr = getattr(model, "dpr", None)
        dp = None if dpr is None else stack_dp_masks(dpr, batch, generator, device)
        keep = [m.reshape(batch, n_points, w) for m, w in zip(
            sample_dropout_masks(batch, [n_points * w for w in model.DROPOUT_WIDTHS],
                                 DROPOUT_RATE, generator, device), model.DROPOUT_WIDTHS)]
        return cls(scale, shift, dp, keep)


def seg_nll_loss(logp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """NLL over per-point log-probs (``partseg.py:106-109``)."""
    return -logp.gather(-1, target.long()[..., None]).mean()


def _model_draws(model: nn.Module, pts: torch.Tensor, draws: Optional[SegDraws],
                 generator: Optional[torch.Generator]) -> Optional[SegDraws]:
    if not model.training:
        return None
    if draws is None:
        draws = SegDraws.sample(model, pts.shape[0], pts.shape[1], generator, pts.device)
    return draws


class _Propagation(nn.Module):
    """The reference's ``propagation_0`` (PointNetFeaturePropagation): the
    per-point Dense + BatchNorm + ReLU stack, bias-free as in the JAX model
    (flax ``prop_fc{i}`` / ``prop_bn{i}``)."""

    def __init__(self, din: int, widths: Sequence[int], generator=None):
        super().__init__()
        convs, bns = [], []
        for w in widths:
            convs.append(Dense(din, w, bias=False, generator=generator))
            bns.append(BatchNorm(w))
            din = w
        self.mlp_convs = nn.ModuleList(convs)
        self.mlp_bns = nn.ModuleList(bns)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            h = torch.relu(bn(conv(h)))
        return h


@MODELS.register_module()
class PointTransformerPartSeg(nn.Module):
    """``partseg.py:46-103``: the patch embedding, a 12-block ViT whose
    outputs at blocks (3, 7, 11) go through one shared LayerNorm and are
    concatenated, max + mean globals with the label embedding, 3-NN
    interpolation from the patch centres back to every point
    (``three_interpolate``, whose backward is the scatter kernel on CUDA),
    ``propagation_0``, and the head ``convs1`` (a ``SplitDense`` with the
    global half last) -> 512 -> Dropout(0.5) -> 256 -> parts."""

    FETCH = (3, 7, 11)
    DROPOUT_WIDTHS = (512,)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        c, g = config, generator
        C = int(c.get("trans_dim", 384))
        depth = int(c.get("depth", 12))
        self.num_group, self.group_size = int(c.get("num_group", 128)), int(c.get("group_size", 32))
        fetched = len([i for i in self.FETCH if i < depth])
        if fetched == 0:
            raise ValueError(f"depth {depth} reaches none of the fetched blocks {self.FETCH}")
        self.encoder = PatchEncoder(int(c.get("encoder_dims", 384)), generator=g)
        self.pos_embed = PosEmbedMLP(C, generator=g)
        self.blocks = TransformerEncoder(C, depth, int(c.get("num_heads", 6)),
                                         drop_path_rate=float(c.get("drop_path_rate", 0.1)),
                                         generator=g)
        self.dpr = self.blocks.dpr
        self.norm = LayerNorm(C)
        self.label_conv = nn.ModuleList([Dense(N_CATEGORIES, 64, bias=False, generator=g),
                                         BatchNorm(64)])
        feat = fetched * C
        self.propagation_0 = _Propagation(3 + feat, (4 * C, 1024), g)
        self.convs1 = SplitDense(1024 + 2 * feat + 64, 512, generator=g, shared_last=True)
        self.bns1 = BatchNorm(512)
        self.convs2 = Dense(512, 256, generator=g)
        self.bns2 = BatchNorm(256)
        self.convs3 = Dense(256, int(c.get("cls_dim", 50)), generator=g)

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                draws: Optional[SegDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pts = pts[..., :3]
        draws = _model_draws(self, pts, draws, generator)
        dp = None if draws is None else draws.drop_path
        neigh, center = group_neighborhood(pts, self.num_group, self.group_size)
        x = self.encoder(neigh)
        pos = self.pos_embed(center)
        feats = []
        for i, blk in enumerate(self.blocks.blocks):
            x = blk(x + pos, None, None if dp is None else dp[i])
            if i in self.FETCH:
                feats.append(self.norm(x))
        x = torch.cat(feats, -1)                                  # (B, G, 3C)
        cls_feat = leaky_relu02(self.label_conv[1](self.label_conv[0](cls_label)))
        global_feat = torch.cat([x.amax(1), x.mean(1), cls_feat], -1)
        dist, idx = three_nn(pts, center)
        h = self.propagation_0(torch.cat([pts, three_interpolate(x, idx, dist)], -1))
        h = torch.relu(self.bns1(self.convs1(global_feat, h)))
        if draws is not None:
            h = dropout_from_mask(h, draws.dropout[0], DROPOUT_RATE)
        h = torch.relu(self.bns2(self.convs2(h)))
        return F.log_softmax(self.convs3(h), dim=-1)


@MODELS.register_module()
class DGCNNPartSeg(nn.Module):
    """``partseg.py:112-155``: ``DGCNNPartSegEncoder`` with its stage
    features, the label through ``conv7`` / ``bn7``, then per point
    ``conv8`` (a ``SplitDense`` over [global + label, x1, x2, x3]) -> 256 ->
    Dropout -> ``conv9`` 256 -> Dropout -> ``conv10`` 128 -> ``conv11``
    parts, every convolution bias-free with BatchNorm and LeakyReLU(0.2)."""

    DROPOUT_WIDTHS = (256, 256)

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dgcnn_encoder = DGCNNPartSegEncoder(generator=g)
        self.conv7 = _Conv(N_CATEGORIES, 64, None, g)
        self.bn7 = BatchNorm(64)
        self.conv8 = nn.ModuleList([SplitDense(1024 + 64 + 192, 256, bias=False, generator=g)])
        self.bn8 = BatchNorm(256)
        self.conv9 = _Conv(256, 256, None, g)
        self.bn9 = BatchNorm(256)
        self.conv10 = _Conv(256, 128, None, g)
        self.bn10 = BatchNorm(128)
        self.conv11 = Dense(128, int(config.get("cls_dim", 50)), bias=False, generator=g)

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                draws: Optional[SegDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pts = pts[..., :3]
        draws = _model_draws(self, pts, draws, generator)
        gfeat, _, stages = self.dgcnn_encoder(pts, return_stages=True)
        lab = leaky_relu02(self.bn7(self.conv7[0](cls_label)))
        h = self.conv8[0](torch.cat([gfeat, lab], -1), torch.cat(stages, -1))
        h = leaky_relu02(self.bn8(h))
        for i, (conv, bn) in enumerate(((self.conv9, self.bn9), (self.conv10, self.bn10))):
            if draws is not None:
                h = dropout_from_mask(h, draws.dropout[i], DROPOUT_RATE)
            h = leaky_relu02(bn(conv[0](h)))
        return F.log_softmax(self.conv11(h), dim=-1)


@MODELS.register_module()
class PointNetNoTPartSeg(nn.Module):
    """``partseg.py:158-196``: five pointwise Dense + BatchNorm stages whose
    pre-ReLU outputs are the skips, a max over the last one, the raw
    one-hot label, then ``convs1`` (a ``SplitDense`` over [global, skips],
    4944 -> 256) -> ``convs2`` 256 -> ``convs3`` 128 -> ``convs4`` parts,
    with biases, BatchNorm and ReLU and no dropout. No random draws."""

    WIDTHS = (64, 128, 128, 512, 2048)
    DROPOUT_WIDTHS = ()

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        din = 3
        for i, w in enumerate(self.WIDTHS, start=1):
            setattr(self, f"conv{i}", Dense(din, w, generator=g))
            setattr(self, f"bn{i}", BatchNorm(w))
            din = w
        self.convs1 = SplitDense(self.WIDTHS[-1] + N_CATEGORIES + sum(self.WIDTHS), 256,
                                 generator=g)
        self.bns1 = BatchNorm(256)
        self.convs2 = Dense(256, 256, generator=g)
        self.bns2 = BatchNorm(256)
        self.convs3 = Dense(256, 128, generator=g)
        self.bns3 = BatchNorm(128)
        self.convs4 = Dense(128, int(config.get("cls_dim", 50)), generator=g)

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                draws: Optional[SegDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, feats = pts[..., :3], []
        for i in range(1, len(self.WIDTHS) + 1):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            feats.append(h)                                   # pre-ReLU skips
            h = torch.relu(h)
        glob = torch.cat([feats[-1].amax(1), cls_label], -1)
        h = torch.relu(self.bns1(self.convs1(glob, torch.cat(feats, -1))))
        for i in (2, 3):
            h = torch.relu(getattr(self, f"bns{i}")(getattr(self, f"convs{i}")(h)))
        return F.log_softmax(self.convs4(h), dim=-1)
