"""Building blocks shared by the models (port of
``point_dae_tpu/models/layers.py:20-538``).

Everything is channel-last, as in the JAX package. Weights are stored in
torch's ``(out, in)`` layout under the reference's torch names; numerics
follow flax: LayerNorm eps 1e-6, statistics as E[x^2] - E[x]^2 in f32,
BatchNorm running statistics updated with the *biased* batch variance at
flax momentum 0.9, a compute ``dtype`` (bf16) for products while
parameters, the residual stream and the norms' statistics stay f32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import fused_attention, supported as attn_supported
from ..ops.mlp import fused_mlp_ln, supported as mlp_supported

_LECUN_TRUNC = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _LECUN_TRUNC
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _compute(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, w.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` computed in ``dtype`` (or the
    promoted input type), the product and the bias add rounded separately.
    ``weight`` is ``(out, in)``."""

    def __init__(self, din: int, dout: int, bias: bool = True, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(lecun_normal_(torch.empty(dout, din), din, generator))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute(x, self.weight, self.dtype)
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


class SplitDense(Dense):
    """``Dense`` over ``concat([shared, per_point], -1)`` factorised by
    linearity: the shared operand has one axis fewer and its projection is
    broadcast over ``per_point``'s extra axis. Same weight as the Dense on
    the concat (``(out, C + E)``)."""

    def forward(self, shared: torch.Tensor, per_point: torch.Tensor) -> torch.Tensor:
        C = shared.shape[-1]
        dt = _compute(shared, self.weight, self.dtype)
        w = self.weight.to(dt)
        sp = torch.matmul(shared.to(dt), w[:, :C].t())
        pp = torch.matmul(per_point.to(dt), w[:, C:].t())
        out = pp + sp[..., None, :]
        return out if self.bias is None else out + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6, fast variance), output cast to
    ``dtype`` when given."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y if self.dtype is None else y.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the last (momentum 0.9,
    eps 1e-5). In training the batch statistics normalise and the running
    statistics move by ``m * running + (1 - m) * batch`` with the biased
    batch variance, which ``torch.nn.BatchNorm1d`` does not do."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5, dtype=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics towards a batch's (biased) ones."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mu = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mu * mu).clamp_min(0.0)
            self.update_running(mu, var)
        else:
            mu, var = self.running_mean, self.running_var
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y if self.dtype is None else y.to(self.dtype)


class MLP(nn.Sequential):
    """Dense + ReLU stack without norms (``coarse_pred``); ReLUs sit between
    the Dense layers so the torch names are ``0, 2, 4, ...``."""

    def __init__(self, din: int, features: Sequence[int], dtype=None,
                 generator: Optional[torch.Generator] = None):
        mods = []
        for i, f in enumerate(features):
            if i:
                mods.append(nn.ReLU())
            mods.append(Dense(din, f, dtype=dtype, generator=generator))
            din = f
        super().__init__(*mods)


class SplitMLP(nn.Sequential):
    """``MLP`` whose first layer is a ``SplitDense`` over
    ``[shared, per_point]`` (the folding stages)."""

    def __init__(self, d_shared: int, d_point: int, features: Sequence[int],
                 dtype=None, generator: Optional[torch.Generator] = None):
        mods = [SplitDense(d_shared + d_point, features[0], dtype=dtype,
                           generator=generator)]
        din = features[0]
        for f in features[1:]:
            mods += [nn.ReLU(), Dense(din, f, dtype=dtype, generator=generator)]
            din = f
        super().__init__(*mods)

    def forward(self, shared: torch.Tensor, per_point: torch.Tensor) -> torch.Tensor:
        x = self[0](shared, per_point)
        for mod in list(self)[1:]:
            x = mod(x)
        return x


def drop_path_from_mask(x: torch.Tensor, keep_mask: torch.Tensor,
                        rate: float) -> torch.Tensor:
    """Stochastic depth with a given per-sample keep mask (B,)."""
    if rate == 0.0:
        return x
    mask = keep_mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def stack_dp_masks(dpr: Sequence[float], batch: int,
                   generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
    """A stack's keep masks from one uniform draw: (depth, 2, B) bool,
    keep with probability 1 - rate (``layers._stack_dp_masks``), or None
    when every rate is 0."""
    if max(dpr) == 0.0:
        return None
    u = torch.rand((len(dpr), 2, batch), generator=generator, device=device)
    rates = torch.tensor(dpr, dtype=torch.float32, device=device)[:, None, None]
    return u >= rates


class Attention(nn.Module):
    """ViT multi-head self-attention with an optional key-validity mask.
    At bf16 compute on a CUDA tensor whose shapes pass
    ``ops.attention.supported`` (the gate of
    ``point_dae_tpu/models/layers.py:231-235`` without its environment
    switch, ``pick_bc`` and the tile terms included) it runs as the
    ``fused_attention`` kernel;
    otherwise unfused: f32 scores, an additive -1e9 on invalid keys, f32
    softmax and values product. Either way the output is cast to the
    compute dtype before ``proj``."""

    def __init__(self, dim: int, num_heads: int, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype, generator=generator)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)

    def forward_fused(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The fused branch: q, k, v stay views of the ``qkv`` output."""
        B, N, C = x.shape
        H = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, H, C // H).unbind(2)
        out = fused_attention(q, k, v, key_mask).reshape(B, N, C)
        return self.proj(out.to(x.dtype if self.dtype is None else self.dtype))

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        if (self.dtype == torch.bfloat16 and x.device.type == "cuda"
                and attn_supported(B, N, H, C // H)):
            return self.forward_fused(x, key_mask)
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()
        attn = torch.matmul(q, k.transpose(-1, -2)) * (C // H) ** -0.5
        if key_mask is not None:
            attn = attn + torch.where(key_mask[:, None, None, :], 0.0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        out = out.to(x.dtype if self.dtype is None else self.dtype)
        return self.proj(out)


class _MlpParams(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, generator):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype, generator=generator)
        self.fc2 = Dense(hidden, dim, dtype=dtype, generator=generator)


class TransformerBlock(nn.Module):
    """Pre-norm ViT block with an f32 residual stream. At bf16 compute on a
    CUDA tensor whose shapes pass ``ops.mlp.supported`` (the gate of
    ``layers.py:331-345``), the LN2 + MLP + stochastic depth + residual half
    runs as the ``fused_mlp_ln`` kernel."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype=dtype, generator=generator)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = _MlpParams(dim, hidden, dtype, generator)

    def _dp(self, h, dp_mask, i):
        if dp_mask is None:
            return h
        return drop_path_from_mask(h, dp_mask[i], self.drop_path_rate)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                dp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C) f32; dp_mask (2, B) bool keep masks or None."""
        h = self.attn(self.norm1(x), key_mask).to(x.dtype)
        x = x + self._dp(h, dp_mask, 0)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        B, T, C = x.shape
        if (self.dtype == torch.bfloat16 and x.dtype == torch.float32
                and x.device.type == "cuda"
                and mlp_supported(B * T, C, fc1.weight.shape[0])):
            row_scale = None
            if dp_mask is not None and self.drop_path_rate != 0.0:
                keep = 1.0 - self.drop_path_rate
                sc = torch.where(dp_mask[1], 1.0 / keep, 0.0)
                row_scale = sc.repeat_interleave(T)
            return fused_mlp_ln(x, self.norm2.weight, self.norm2.bias,
                                fc1.weight.t(), fc1.bias, fc2.weight.t(),
                                fc2.bias, row_scale=row_scale)
        h = F.gelu(fc1(self.norm2(x)))
        h = fc2(h).to(x.dtype)
        return x + self._dp(h, dp_mask, 1)


def _dpr(rate: float, depth: int):
    return [rate * i / max(depth - 1, 1) for i in range(depth)]


class TransformerEncoder(nn.Module):
    """Block stack with the positional embedding re-added before every
    block. Torch names: ``blocks.{i}``."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float = 0.0, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dpr = _dpr(drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, drop_path_rate=r, dtype=dtype,
                             generator=generator) for r in self.dpr)

    def forward(self, x, pos, key_mask=None, dp_masks=None):
        """dp_masks: (depth, 2, B) bool or None (no stochastic depth)."""
        for i, blk in enumerate(self.blocks):
            x = blk(x + pos, key_mask, None if dp_masks is None else dp_masks[i])
        return x


class TransformerDecoder(TransformerEncoder):
    """``TransformerEncoder`` plus a final f32 LayerNorm (``norm``)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float = 0.0, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim, depth, num_heads, drop_path_rate, dtype, generator)
        self.norm = LayerNorm(dim)

    def forward(self, x, pos, key_mask=None, dp_masks=None):
        return self.norm(super().forward(x, pos, key_mask, dp_masks))


class PosEmbedMLP(nn.Sequential):
    """3 -> 128 -> dim GELU MLP (f32). Torch names ``0`` and ``2``."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__(Dense(3, 128, generator=generator), nn.GELU(),
                         Dense(128, dim, generator=generator))


class PatchEncoder(nn.Module):
    """Mini-PointNet patch embedding: (B, G, S, 3) -> (B, G, C) f32.
    ``first_conv`` = Dense 3->128, BN, ReLU, Dense 128->256; the per-patch
    max is concatenated back (as a ``SplitDense``) into ``second_conv`` =
    512->512, BN, ReLU, 512->C; a final max over the patch."""

    def __init__(self, encoder_channel: int, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.first_conv = nn.ModuleList([
            Dense(3, 128, dtype=dtype, generator=generator),
            BatchNorm(128, dtype=dtype), nn.ReLU(),
            Dense(128, 256, dtype=dtype, generator=generator)])
        self.second_conv = nn.ModuleList([
            SplitDense(512, 512, dtype=dtype, generator=generator),
            BatchNorm(512, dtype=dtype), nn.ReLU(),
            Dense(512, encoder_channel, dtype=dtype, generator=generator)])

    def forward(self, groups: torch.Tensor) -> torch.Tensor:
        B, G, S, C = groups.shape
        x = groups.reshape(B * G, S, C)
        conv1, bn1, _, conv2 = self.first_conv
        conv3, bn2, _, conv4 = self.second_conv
        h = conv2(torch.relu(bn1(conv1(x))))
        g = h.amax(dim=1)                                    # (BG, 256)
        h = conv4(torch.relu(bn2(conv3(g, h))))
        return h.amax(dim=1).reshape(B, G, self.encoder_channel).float()
