"""The discrete VAE point tokenizer (port of ``point_dae_tpu/models/dvae.py``,
Point-BERT's dVAE): the frozen tokenizer of ``MaskSurf_v2_token_dis`` and
the ``Point_dVAE`` pretrain model that trains it.

Torch names follow Point-BERT's ``dVAE.pth`` (``encoder.``, ``dgcnn_1.``,
``codebook``, ``dgcnn_2.``, ``decoder.``) with its 1x1 convolutions as
``(out, in)`` dense weights, so such a file loads once its convolution
weights lose their trailing unit axes (``engine/pretrain.py``). The Gumbel
noise of a training forward is an input (``Point_dVAE.sample_draws``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..losses.chamfer import chamfer_l1
from ..ops.geometry import group_neighborhood, knn
from ..utils.registry import MODELS
from .layers import MLP, BatchNorm, Dense, PatchEncoder, SplitDense, leaky_relu02


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (eps 1e-6, fast variance in f32) over a
    channel-last input: statistics per sample and group of channels, over
    every axis but the first."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xf = x.float()
        ng = self.num_groups
        g = xf.reshape(B, -1, ng, C // ng)
        mu = g.mean((1, 3), keepdim=True)
        var = ((g * g).mean((1, 3), keepdim=True) - mu * mu).clamp_min(0.0)
        y = (g - mu) * (torch.rsqrt(var + self.eps) * self.weight.reshape(ng, C // ng))
        return y.reshape(x.shape) + self.bias


def graph_feature(coor: torch.Tensor, x: torch.Tensor, k: int = 4) -> torch.Tensor:
    """DGCNN edge features over the patch centres: coor (B, G, 3), x (B, G,
    C) -> (B, G, k, 2C) = [neighbour - self, self] over the k nearest
    centres (the centre itself first)."""
    _, idx = knn(coor, coor, k)                                  # (B, G, k)
    B, G, C = x.shape
    neigh = torch.gather(x, 1, idx.long().reshape(B, G * k, 1).expand(-1, -1, C))
    neigh = neigh.reshape(B, G, k, C)
    self_f = x[:, :, None, :].expand_as(neigh)
    return torch.cat([neigh - self_f, self_f], -1)


class PatchDGCNN(nn.Module):
    """Four EdgeConv layers over the patch tokens and a fuse (Point-BERT's
    DGCNN): input -> 128, then 256, 512, 512, 1024 wide, the four
    concatenated (2304) -> ``out_channel``; GroupNorm(4) and LeakyReLU(0.2)
    after each. Torch names ``input_trans``, ``layer{1..5}.{0: dense, 1:
    norm}``."""

    WIDTHS = (256, 512, 512, 1024)

    def __init__(self, din: int, out_channel: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_trans = Dense(din, 128, generator=generator)
        cin = 128
        for i, width in enumerate(self.WIDTHS, 1):
            setattr(self, f"layer{i}", nn.ModuleList([
                Dense(2 * cin, width, bias=False, generator=generator), GroupNorm(4, width)]))
            cin = width
        self.layer5 = nn.ModuleList([Dense(sum(self.WIDTHS), out_channel, bias=False,
                                           generator=generator), GroupNorm(4, out_channel)])

    def forward(self, f: torch.Tensor, coor: torch.Tensor) -> torch.Tensor:
        f = self.input_trans(f)
        feats = []
        for i in range(1, 5):
            dense, norm = getattr(self, f"layer{i}")
            f = leaky_relu02(norm(dense(graph_feature(coor, f)))).amax(2)
            feats.append(f)
        dense, norm = self.layer5
        return leaky_relu02(norm(dense(torch.cat(feats, -1))))


class FoldingPatchDecoder(nn.Module):
    """A patch's coarse points from an MLP, refined by folding a 2x2 grid
    around each (Point-BERT's Decoder): (B, G, C) -> (coarse (B, G, S/4,
    3), fine (B, G, S, 3)). Torch names ``mlp.{0,2,4}`` and
    ``final_conv.{0, 1, 3, 4, 6}`` (dense, BatchNorm, dense, BatchNorm,
    dense); the first fine dense runs over [feature, seed, point] as a
    ``SplitDense``."""

    def __init__(self, din: int, num_fine: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_fine = num_fine
        self.num_coarse = num_fine // 4
        self.mlp = MLP(din, (1024, 1024, 3 * self.num_coarse), generator=generator)
        self.final_conv = nn.Sequential(
            SplitDense(din + 5, 512, generator=generator), BatchNorm(512), nn.ReLU(),
            Dense(512, 512, generator=generator), BatchNorm(512), nn.ReLU(),
            Dense(512, 3, generator=generator))
        lin = torch.linspace(-0.05, 0.05, 2)
        seed = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1).reshape(4, 2)
        self.register_buffer("seed", seed, persistent=False)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, G, C = feat.shape
        nc = self.num_coarse
        f = feat.reshape(B * G, C)
        coarse = self.mlp(f).reshape(B * G, nc, 3)
        seed = self.seed.expand(B * G, nc, 4, 2)
        pt = coarse[:, :, None, :].expand(B * G, nc, 4, 3)
        pp = torch.cat([seed, pt], -1).reshape(B * G, self.num_fine, 5)
        fc0, bn0, _, fc1, bn1, _, fc2 = self.final_conv
        h = torch.relu(bn0(fc0(f, pp)))
        h = torch.relu(bn1(fc1(h)))
        fine = fc2(h) + pt.reshape(B * G, self.num_fine, 3)
        return coarse.reshape(B, G, nc, 3), fine.reshape(B, G, self.num_fine, 3)


@MODELS.register_module()
class DiscreteVAE(nn.Module):
    """dVAE tokenizer over ``num_group`` patches of ``group_size`` points:
    ``tokenize`` gives each patch's logits over ``num_tokens``; the forward
    autoencodes through a Gumbel-softmax over the codebook (straight-through
    one-hot with ``hard``) and returns (coarse, fine, neighborhood, center,
    logits). ``tokenizer_only`` builds the encoder, ``dgcnn_1`` and the
    codebook alone, the parts that ``tokenize`` runs."""

    def __init__(self, config, generator: Optional[torch.Generator] = None,
                 tokenizer_only: bool = False):
        super().__init__()
        c = config
        g = generator
        self.num_group, self.group_size = int(c["num_group"]), int(c["group_size"])
        self.num_tokens = int(c.get("num_tokens", 8192))
        enc, tok = int(c.get("encoder_dims", 256)), int(c.get("tokens_dims", 256))
        self.encoder = PatchEncoder(enc, generator=g)
        self.dgcnn_1 = PatchDGCNN(enc, self.num_tokens, g)
        self.codebook = nn.Parameter(torch.randn(self.num_tokens, tok, generator=g))
        if not tokenizer_only:
            dec = int(c.get("decoder_dims", 256))
            self.dgcnn_2 = PatchDGCNN(tok, dec, g)
            self.decoder = FoldingPatchDecoder(dec, self.group_size, g)

    def tokenize_groups(self, neigh: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
        """Logits (B, G, V) of patches grouped already."""
        return self.dgcnn_1(self.encoder(neigh), center)

    def tokenize(self, pts: torch.Tensor):
        """(B, N, 3) -> (logits (B, G, V), neighborhood, center)."""
        neigh, center = group_neighborhood(pts[..., :3], self.num_group, self.group_size)
        return self.tokenize_groups(neigh, center), neigh, center

    def decode_tokens(self, ids: torch.Tensor, center: torch.Tensor):
        """Token ids (B, G) through the codebook, ``dgcnn_2`` and the
        decoder: (coarse, fine), centred on the patches."""
        return self.decoder(self.dgcnn_2(self.codebook[ids.long()], center))

    def forward(self, pts: torch.Tensor, temperature: float = 1.0, hard: bool = False,
                gumbel: Optional[torch.Tensor] = None):
        """In training ``gumbel`` (B, G, V) is the noise added to the logits;
        in eval mode there is none."""
        logits, neigh, center = self.tokenize(pts)
        if self.training:
            y = torch.softmax((logits + gumbel) / temperature, -1)
        else:
            y = torch.softmax(logits / temperature, -1)
        if hard:
            onehot = nn.functional.one_hot(y.argmax(-1), self.num_tokens).to(y.dtype)
            y = onehot + y - y.detach()                           # straight-through
        feat = self.dgcnn_2(torch.matmul(y, self.codebook), center)
        coarse, fine = self.decoder(feat)
        return coarse, fine, neigh, center, logits


def sample_gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


@MODELS.register_module()
class Point_dVAE(nn.Module):
    """The trainable dVAE in the pretrain contract: ``model(corrupted,
    clean, draws=None, generator=None) -> (reconstruction chamfer, codebook
    KL)``, autoencoding the clean cloud; ``loss_type: xyznormal`` weighs the
    KL by ``normal_weight``. ``temperature`` (default 1.0) and ``hard``
    come from the config; ``draws`` is the Gumbel noise (B, G, V). Its
    checkpoint (``dvae.`` names) loads into ``MaskSurf_v2_token_dis``
    through ``model.dvae_config.ckpt``."""

    def __init__(self, config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dvae = DiscreteVAE(dict(config), generator=generator)
        self.temperature = float(config.get("temperature", 1.0))
        self.hard = str(config.get("hard", "False")) == "True"

    def sample_draws(self, batch: int, generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
        return sample_gumbel((batch, self.dvae.num_group, self.dvae.num_tokens),
                             generator, device)

    def forward(self, corrupted, clean, draws: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        del corrupted
        if self.training and draws is None:
            draws = self.sample_draws(clean.shape[0], generator, clean.device)
        coarse, fine, neigh, _, logits = self.dvae(clean[..., :3], self.temperature,
                                                   self.hard, gumbel=draws)
        return dvae_loss_parts(coarse, fine, neigh, logits)

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """SVM-probe feature: max + mean over the patches' token logits."""
        logits = self.dvae.tokenize(pts)[0]
        return logits.amax(1) + logits.mean(1)


def dvae_loss_parts(coarse, fine, neigh, logits):
    """(chamfer-L1 of the fine and of the coarse patches against the true
    ones, KL of the batch's mean token distribution to the uniform one)."""
    B, G, S, _ = neigh.shape
    gt = neigh.reshape(B * G, S, 3)
    rec = chamfer_l1(fine.reshape(B * G, -1, 3), gt) + chamfer_l1(coarse.reshape(B * G, -1, 3), gt)
    mean_p = torch.log_softmax(logits, -1).exp().mean((0, 1))
    kl = (mean_p * (torch.log(mean_p + 1e-10) + torch.log(
        torch.tensor(float(logits.shape[-1]), device=logits.device)))).sum()
    return rec, kl


def dvae_loss(coarse, fine, neigh, logits, kl_weight: float = 0.0):
    """The reconstruction chamfer, plus ``kl_weight`` times the KL."""
    rec, kl = dvae_loss_parts(coarse, fine, neigh, logits)
    return rec + kl_weight * kl if kl_weight > 0.0 else rec
