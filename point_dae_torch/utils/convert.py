"""Weight bridge between the port's ``state_dict`` and the JAX package's
flax ``(params, batch_stats)`` trees.

Port parameters carry the reference's torch names (the names that
``point_dae_tpu/utils/convert_torch.py`` translates), so one table maps
each torch module prefix to its flax path. Leaves translate as the
reference converter does: a 2-D ``weight`` is a dense kernel stored
``(out, in)`` in torch and ``(in, out)`` in flax, a 1-D ``weight`` is a norm
``scale``, and the BatchNorm ``running_mean``/``running_var`` buffers are the
flax ``batch_stats`` leaves ``mean``/``var``. The 3DETR encoder's attention
(``nn.MultiheadAttention``'s names, which the JAX converter has no rules
for) is split and merged: ``in_proj_weight`` (3 C, C) and ``in_proj_bias``
are flax's ``query``, ``key`` and ``value`` kernels (C, heads, head_dim)
and biases (heads, head_dim); ``out_proj.weight`` is the ``out`` kernel
(heads, head_dim, C).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# (torch module prefix, flax path); {i} (and {j}) are indices
_RULES = [
    ("MAE_encoder.encoder.first_conv.0", "MAE_encoder/encoder/conv1"),
    ("MAE_encoder.encoder.first_conv.1", "MAE_encoder/encoder/bn1"),
    ("MAE_encoder.encoder.first_conv.3", "MAE_encoder/encoder/conv2"),
    ("MAE_encoder.encoder.second_conv.0", "MAE_encoder/encoder/conv3"),
    ("MAE_encoder.encoder.second_conv.1", "MAE_encoder/encoder/bn2"),
    ("MAE_encoder.encoder.second_conv.3", "MAE_encoder/encoder/conv4"),
    ("MAE_encoder.pos_embed.0", "MAE_encoder/pos_embed/fc1"),
    ("MAE_encoder.pos_embed.2", "MAE_encoder/pos_embed/fc2"),
    ("MAE_encoder.norm", "MAE_encoder/norm"),
    ("decoder_pos_embed.0", "decoder_pos_embed/fc1"),
    ("decoder_pos_embed.2", "decoder_pos_embed/fc2"),
    ("MAE_decoder.norm", "MAE_decoder/norm"),
    ("mask_token", "mask_token"),
    ("coarse_pred.0", "coarse_pred/dense0"),
    ("coarse_pred.2", "coarse_pred/dense1"),
    ("coarse_pred.4", "coarse_pred/dense2"),
    ("folding1.0", "fold/folding1/dense0"),
    ("folding1.2", "fold/folding1/dense1"),
    ("folding1.4", "fold/folding1/dense2"),
    ("folding2.0", "fold/folding2/dense0"),
    ("folding2.2", "fold/folding2/dense1"),
    ("folding2.4", "fold/folding2/dense2"),
]
# a transformer block's leaves
_BLOCK_LEAVES = (("norm1", "norm1"), ("attn.qkv", "attn/qkv"), ("attn.proj", "attn/proj"),
                 ("norm2", "norm2"), ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2"))
for _torch, _flax in (("MAE_encoder.blocks.blocks.{i}", "MAE_encoder/blocks/block{i}"),
                      ("MAE_decoder.blocks.{i}", "MAE_decoder/block{i}")):
    for _t, _f in _BLOCK_LEAVES:
        _RULES.append((f"{_torch}.{_t}", f"{_flax}/{_f}"))

# MaskFeat_dgcnn: its DGCNN teacher and the 1024-wide head
for _i in range(1, 5):
    _RULES += [(f"teacher.conv{_i}.0", f"teacher/ec{_i}/conv"),
               (f"teacher.bn{_i}", f"teacher/ec{_i}/bn")]
_RULES += [("teacher.conv5.0", "teacher/conv5"), ("teacher.bn5", "teacher/bn5"),
           ("increase_dim", "increase_dim")]

# the MaskSurf family's second head (convert_torch._MASKSURF_RULES)
_RULES.append(("increase_dim2", "increase_dim2"))

# the PointCAE heads: the reference's Conv1d ``increase_dim.0`` (convert_torch
# _TRANSFORMER_RULES); ``increase_dim_fine`` and a global folding head, which
# the JAX converter has no rules for, under their flax paths
_RULES += [("increase_dim.0", "increase_dim"), ("increase_dim_fine", "increase_dim_fine")]
_RULES += [(f"global_fold.folding{_f}.{2 * _d}", f"global_fold/folding{_f}/dense{_d}")
           for _f in (1, 2) for _d in range(3)]

# the dVAE tokenizer (convert_torch._DVAE_RULES, Point-BERT's names) under
# Point_dVAE's ``dvae`` and MaskSurf_v2_token_dis's ``dvae_teacher``
for _p in ("dvae", "dvae_teacher"):
    _RULES += [(f"{_p}.encoder.first_conv.0", f"{_p}/encoder/conv1"),
               (f"{_p}.encoder.first_conv.1", f"{_p}/encoder/bn1"),
               (f"{_p}.encoder.first_conv.3", f"{_p}/encoder/conv2"),
               (f"{_p}.encoder.second_conv.0", f"{_p}/encoder/conv3"),
               (f"{_p}.encoder.second_conv.1", f"{_p}/encoder/bn2"),
               (f"{_p}.encoder.second_conv.3", f"{_p}/encoder/conv4"),
               (f"{_p}.codebook", f"{_p}/codebook")]
    for _d in ("dgcnn_1", "dgcnn_2"):
        _RULES.append((f"{_p}.{_d}.input_trans", f"{_p}/{_d}/input_trans"))
        _RULES += [(f"{_p}.{_d}.layer{_i}.{_j}", f"{_p}/{_d}/layer{_i}{_s}")
                   for _i in range(1, 6) for _j, _s in ((0, ""), (1, "_gn"))]
    _RULES += [(f"{_p}.decoder.mlp.{2 * _i}", f"{_p}/decoder/mlp/dense{_i}") for _i in range(3)]
    _RULES += [(f"{_p}.decoder.final_conv.{_i}", f"{_p}/decoder/{_f}")
               for _i, _f in ((0, "final0"), (1, "final_bn0"), (3, "final1"),
                              (4, "final_bn1"), (6, "final_out"))]

# the DGCNN family (convert_torch._DGCNN_RULES)
_DGCNN_ENCODER = []
for _i in range(1, 5):
    _DGCNN_ENCODER.append((f"dgcnn_encoder.conv{_i}.0", f"dgcnn_encoder/ec{_i}/conv"))
    _DGCNN_ENCODER.append((f"dgcnn_encoder.bn{_i}", f"dgcnn_encoder/ec{_i}/bn"))
_DGCNN_ENCODER += [("dgcnn_encoder.conv5.0", "dgcnn_encoder/conv5"),
                   ("dgcnn_encoder.bn5", "dgcnn_encoder/bn5")]
_RULES += [("recfc.0", "recfc/dense0"), ("recfc.2", "recfc/dense1"),
           ("recfc.4", "recfc/dense2")]

# the part-segmentation models (convert_torch has no rules for them): the
# reference's torch names against the JAX models' flax names
_RULES += [("label_conv.0", "label_conv"), ("label_conv.1", "label_bn"),
           ("propagation_0.mlp_convs.{i}", "prop_fc{i}"),
           ("propagation_0.mlp_bns.{i}", "prop_bn{i}")]
_RULES += [(f"{n}{_i}", f"{n}{_i}") for n, hi in (("convs", 4), ("bns", 3))
           for _i in range(1, hi + 1)]                     # PointTransformer, PointNet
_RULES += [(f"{n}{_i}", f"{n}{_i}") for n in ("conv", "bn") for _i in range(1, 6)]  # PointNet
_RULES += [(f"conv{_i}.0", f"conv{_i}") for _i in range(7, 11)]      # DGCNNPartSeg head
_RULES += [(f"bn{_i}", f"bn{_i}") for _i in range(7, 11)] + [("conv11", "conv11")]
# DGCNNPartSegEncoder: the five stage convolutions in order, then the fuse
_DGCNN_PARTSEG_ENCODER = [("dgcnn_encoder.conv6.0", "dgcnn_encoder/conv6"),
                          ("dgcnn_encoder.bn6", "dgcnn_encoder/bn6")]
for _i, (_s, _j) in enumerate(((1, 0), (1, 1), (2, 0), (2, 1), (3, 0)), start=1):
    _DGCNN_PARTSEG_ENCODER += [(f"dgcnn_encoder.conv{_i}.0", f"dgcnn_encoder/s{_s}_conv{_j}"),
                               (f"dgcnn_encoder.bn{_i}", f"dgcnn_encoder/s{_s}_bn{_j}")]

# the PointTransformer fine-tune model: the encoder at the top level
# (convert_torch._TRANSFORMER_RULES, unprefixed)
_RULES += [
    ("encoder.first_conv.0", "encoder/conv1"), ("encoder.first_conv.1", "encoder/bn1"),
    ("encoder.first_conv.3", "encoder/conv2"), ("encoder.second_conv.0", "encoder/conv3"),
    ("encoder.second_conv.1", "encoder/bn2"), ("encoder.second_conv.3", "encoder/conv4"),
    ("pos_embed.0", "pos_embed/fc1"), ("pos_embed.2", "pos_embed/fc2"),
    ("norm", "norm"), ("cls_token", "cls_token"), ("cls_pos", "cls_pos")]
for _t, _f in _BLOCK_LEAVES:
    _RULES.append((f"blocks.blocks.{{i}}.{_t}", f"blocks/block{{i}}/{_f}"))

# the Point-M2AE family (convert_torch._M2AE_RULES); {j} is a block index
# within stage {i}
for _t, _f in (("first_conv.0", "conv1"), ("first_conv.1", "bn1"), ("first_conv.3", "conv2"),
               ("second_conv.0", "conv3"), ("second_conv.1", "bn2"),
               ("second_conv.3", "conv4")):
    _RULES.append((f"h_encoder.token_embed.{{i}}.{_t}", f"h_encoder/token_embed{{i}}/{_f}"))
for _t, _f in _BLOCK_LEAVES:
    _RULES += [(f"h_encoder.encoder_blocks.{{i}}.blocks.{{j}}.{_t}",
                f"h_encoder/stage{{i}}/block{{j}}/{_f}"),
               (f"h_decoder.{{i}}.blocks.{{j}}.{_t}", f"h_decoder{{i}}/block{{j}}/{_f}")]
for _p, _f in (("h_encoder.encoder_pos_embeds", "h_encoder/pos_embed"),
               ("decoder_pos_embeds", "decoder_pos_embed")):
    _RULES += [(f"{_p}.{{i}}.0", f"{_f}{{i}}/dense0"), (f"{_p}.{{i}}.2", f"{_f}{{i}}/dense1")]
_RULES += [("h_encoder.encoder_norms.{i}", "h_encoder/norm{i}"),
           ("token_prop.{i}.fuse.net.0", "token_prop{i}/fuse_conv"),
           ("token_prop.{i}.fuse.net.1", "token_prop{i}/fuse_bn"),
           ("decoder_norm", "decoder_norm"), ("rec_head", "rec_head")]
for _n, _s in (("net1", 1), ("net2", 2)):
    _RULES += [(f"token_prop.{{i}}.extraction.operation.{{j}}.{_n}.0",
                f"token_prop{{i}}/res{{j}}_conv{_s}"),
               (f"token_prop.{{i}}.extraction.operation.{{j}}.{_n}.1",
                f"token_prop{{i}}/res{{j}}_bn{_s}")]
# the fc-center heads: the reference's coarse_pred_0 reads the coarsest of
# its three scales, the JAX package's the finest
_RULES += [(f"coarse_pred_{_k}.{2 * _d}", f"coarse_pred_{2 - _k}/dense{_d}")
           for _k in range(3) for _d in range(3)]
# DGCNN_Linear's classifier
_RULES.append(("cls", "cls"))

# MaskFeat_transformer's frozen teacher: a MaskTransformerEncoder
_RULES += [(f"teacher.{_t}", f"teacher/{_f}") for _t, _f in (
    ("encoder.first_conv.0", "encoder/conv1"), ("encoder.first_conv.1", "encoder/bn1"),
    ("encoder.first_conv.3", "encoder/conv2"), ("encoder.second_conv.0", "encoder/conv3"),
    ("encoder.second_conv.1", "encoder/bn2"), ("encoder.second_conv.3", "encoder/conv4"),
    ("pos_embed.0", "pos_embed/fc1"), ("pos_embed.2", "pos_embed/fc2"), ("norm", "norm"))]
for _t, _f in _BLOCK_LEAVES:
    _RULES.append((f"teacher.blocks.blocks.{{i}}.{_t}", f"teacher/blocks/block{{i}}/{_f}"))

# the 3DETR backbone (3detr's torch names; convert_torch has no rules for it)
_RULES += [("pre_encoder.mlp_module.layer{i}.conv", "pre_encoder/mlp{i}"),
           ("pre_encoder.mlp_module.layer{i}.bn.bn", "pre_encoder/mlp{i}_bn"),
           ("blocks.layers.{i}.self_attn.out_proj", "blocks/layer{i}/self_attn/out"),
           ("blocks.layers.{i}.self_attn", "blocks/layer{i}/self_attn"),
           ("blocks.norm", "blocks/norm")]
_RULES += [(f"blocks.layers.{{i}}.{_n}", f"blocks/layer{{i}}/{_n}")
           for _n in ("linear1", "linear2", "norm1", "norm2")]

# the two fine-tune heads share their torch names at other indices, so a
# state_dict takes the DGCNN head's rules when it holds a DGCNN encoder
_TRANSFORMER_HEAD = [(f"cls_head_finetune.{i}", f"cls_head_finetune/{f}")
                     for i, f in ((0, "fc0"), (1, "bn0"), (4, "fc1"), (5, "bn1"),
                                  (8, "cls"))]
_DGCNN_HEAD = [(f"cls_head_finetune.{i}", f"cls_head/{f}")
               for i, f in ((0, "fc1"), (1, "bn1"), (3, "fc2"), (4, "bn2"), (7, "cls"))]

# the PointNet++ family (convert_torch._POINTNET2_RULES): its head shares
# the fine-tune heads' torch names at other indices
_POINTNET2 = [("pointnetv2_encoder.sa{j}.mlps.0.layer{i}.conv",
               "pointnetv2_encoder/sa{j}/mlp{i}_fc"),
              ("pointnetv2_encoder.sa{j}.mlps.0.layer{i}.bn.bn",
               "pointnetv2_encoder/sa{j}/mlp{i}_bn")]
_POINTNET2 += [(f"cls_head_finetune.{i}", f"cls_head/{f}")
               for i, f in ((0, "fc1"), (1, "bn1"), (4, "fc2"), (5, "bn2"), (8, "cls"))]

# the MlMAE family (convert_torch._MLMAE_RULES): the transformer's torch
# names, its encoder's blocks directly under MAE_encoder in the flax tree
_MLMAE = [(f"MAE_encoder.blocks.blocks.{{i}}.{_t}", f"MAE_encoder/block{{i}}/{_f}")
          for _t, _f in _BLOCK_LEAVES]

# the CNN DAEs' decoders at the top level (convert_torch._DGCNN_RULES and
# _POINTNET2_RULES): they go before _RULES, whose folding and pos_embed
# rules are the transformer's. fold_all's and the v6 folding head's folding
# stages sit at the top level of the flax tree too (_TOP_FOLD)
_TOP_FOLD = [(f"folding{_f}.{2 * _d}", f"folding{_f}/dense{_d}")
             for _f in (1, 2) for _d in range(3)]
_CNN_DECODER = _TOP_FOLD + [(f"{_n}.{2 * _d}", f"{_n}/dense{_d}")
                            for _n in ("proj", "pos_embed") for _d in range(2)]

# PointNet++'s FeaturePropagation (pointnet2's PointnetFPModule names)
_RULES += [("mlp.layer{i}.conv", "mlp{i}_fc"), ("mlp.layer{i}.bn.bn", "mlp{i}_bn")]

# the PointNet family (convert_torch._POINTNET_RULES): the STN leaves, the
# encoder, the DAE's FC decoder (torch folding1, flax recfc) and the head
_STN_LEAVES = [(f"conv{_i}", f"c{_i}_fc") for _i in range(1, 4)] + [
    (f"bn{_i}", f"c{_i}_bn") for _i in range(1, 4)] + [
    ("fc1", "f1_fc"), ("bn4", "f1_bn"), ("fc2", "f2_fc"), ("bn5", "f2_bn"), ("fc3", "f3")]
_POINTNET_TAIL = [(f"folding1.{2 * _d}", f"recfc/dense{_d}") for _d in range(3)]
_POINTNET_TAIL += [(f"cls_head_finetune.{i}", f"cls_head/{f}")
                   for i, f in ((0, "fc1"), (1, "bn1"), (4, "fc2"), (5, "bn2"), (7, "cls"))]
_POINTNET = [(f"pointnet_encoder.{_s}.{_t}", f"pointnet_encoder/{_s}/{_f}")
             for _s in ("stn", "fstn") for _t, _f in _STN_LEAVES]
_POINTNET += [(f"pointnet_encoder.{_n}{_i}", f"pointnet_encoder/c{_i}_{_f}")
              for _i in range(1, 4) for _n, _f in (("conv", "fc"), ("bn", "bn"))]
_POINTNET += _POINTNET_TAIL
# the part-segmentation-style PointNet encoder (convert_torch has no rules
# for it): the reference layout's conv1-5 / bn1-5 against flax conv0-4 / bn0-4
_POINTNET_PARTSEG = [(f"pointnet_encoder.{_n}{_i + 1}", f"pointnet_encoder/{_n}{_i}")
                     for _i in range(5) for _n in ("conv", "bn")] + _POINTNET_TAIL

_STATS = {"running_mean": "mean", "running_var": "var"}
_QKV = ("query", "key", "value")
_QKV_PATH = re.compile(r"^(?P<mod>.*/self_attn)/(?P<part>query|key|value)/(?P<leaf>kernel|bias)$")


def _pattern(fmt: str, sep: str) -> re.Pattern:
    esc = re.escape(fmt).replace(r"\{i\}", r"(?P<i>\d+)").replace(r"\{j\}", r"(?P<j>\d+)")
    return re.compile(f"^{esc}(?:{re.escape(sep)}(?P<leaf>[A-Za-z_]+))?$")


# (rules before the generic ones, rules after them) of each family: the
# first matching rule wins
_FAMILIES = {"transformer": ([], _TRANSFORMER_HEAD),
             "dgcnn": (_CNN_DECODER, _DGCNN_ENCODER + _DGCNN_HEAD),
             "dgcnn_partseg": (_CNN_DECODER, _DGCNN_PARTSEG_ENCODER + _DGCNN_HEAD),
             "pointnet2": (_CNN_DECODER, _POINTNET2),
             "pointnet": (_POINTNET, []),
             "pointnet_partseg": (_POINTNET_PARTSEG, []),
             "mlmae": (_MLMAE, _TRANSFORMER_HEAD),
             "transformer_fold": (_TOP_FOLD, _TRANSFORMER_HEAD)}
_TORCH_TO_FLAX = {family: [(_pattern(t, "."), f) for t, f in pre + _RULES + post]
                  for family, (pre, post) in _FAMILIES.items()}
_FLAX_TO_TORCH = [(_pattern(f, "/"), t) for t, f in _RULES + _TRANSFORMER_HEAD + _CNN_DECODER
                  + _DGCNN_ENCODER + _DGCNN_HEAD + _DGCNN_PARTSEG_ENCODER + _MLMAE]
_FLAX_TO_TORCH_PN2 = [(_pattern(f, "/"), t) for t, f in _POINTNET2] + _FLAX_TO_TORCH
_FLAX_TO_TORCH_PN = [(_pattern(f, "/"), t) for t, f in _POINTNET + _POINTNET_PARTSEG] \
    + _FLAX_TO_TORCH


def _family(state_dict) -> str:
    """Which torch-name table a state dict (or a list of its names) takes:
    the DGCNN and PointNet encoders and the fine-tune heads reuse torch
    names at other flax paths."""
    if "dgcnn_encoder.conv6.0.weight" in state_dict:
        return "dgcnn_partseg"
    if any(k.startswith("dgcnn_encoder.") for k in state_dict):
        return "dgcnn"
    if any(k.startswith("pointnetv2_encoder.") for k in state_dict):
        return "pointnet2"
    if "pointnet_encoder.conv5.weight" in state_dict:
        return "pointnet_partseg"
    if any(k.startswith("pointnet_encoder.") for k in state_dict):
        return "pointnet"
    # folding stages at the top level: the flagship family's local fold
    # (flax ``fold/``) beside a decoder, fold_all's and the v6 folding
    # head's (flax ``folding1/``) without one or beside ``increase_dim_fine``
    if "folding1.0.weight" in state_dict and (
            "MAE_decoder.norm.weight" not in state_dict
            or "increase_dim_fine.weight" in state_dict):
        return "transformer_fold"
    return "transformer"


def _match(table, name: str):
    for pat, tmpl in table:
        m = pat.match(name)
        if m:
            idx = {k: v for k, v in m.groupdict().items() if k != "leaf"}
            return tmpl.format(**idx), m.group("leaf")
    raise KeyError(f"no conversion rule for {name!r}")


def _bare(path: str):
    """The torch name of a flax path that a rule maps whole (a parameter
    with no leaf name: mask_token, codebook), else None."""
    for pat, tmpl in _FLAX_TO_TORCH:
        m = pat.match(path)
        if m and m.group("leaf") is None:
            return tmpl
    return None


def _set(tree: Dict, path: str, value) -> None:
    *heads, last = path.split("/")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def flax_paths(names) -> Dict[str, str]:
    """Each torch name -> the flax path of its module in the JAX package's
    tree (the parameter's own path for a bare one such as ``mask_token``);
    the flax leaves (``kernel``, ``scale``, ``bias``, 3DETR's ``query`` ...)
    sit under it."""
    table = _TORCH_TO_FLAX[_family(names)]
    return {name: _match(table, name)[0] for name in names}


def to_flax(state_dict: Dict[str, torch.Tensor], num_heads: Optional[int] = None,
            family: Optional[str] = None) -> Tuple[Dict, Dict]:
    """Port ``state_dict`` -> nested ``(params, batch_stats)`` of numpy
    arrays (copies: later updates of the model leave them as they are),
    laid out as the JAX package's models initialise them. ``num_heads``:
    the 3DETR encoder's head count, which its attention's flax leaves need
    (and its torch ones do not show); ``family="mlmae"`` for the MlMAE
    models, whose torch names do not tell them apart from the flagship's
    (their encoder's blocks sit directly under ``MAE_encoder`` in flax)."""
    params, stats = {}, {}
    table = _TORCH_TO_FLAX[family or _family(state_dict)]
    for name, t in state_dict.items():
        v = t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t)
        path, leaf = _match(table, name)
        if (leaf in ("in_proj_weight", "in_proj_bias")
                or (leaf == "weight" and path.endswith("/self_attn/out"))):
            if num_heads is None:
                raise ValueError(f"{name!r} needs to_flax(..., num_heads=)")
            if leaf == "weight":
                _set(params, f"{path}/kernel", v.T.reshape(num_heads, -1, v.shape[0]))
                continue
            for part, chunk in zip(_QKV, np.split(v, 3)):
                if leaf == "in_proj_weight":
                    _set(params, f"{path}/{part}/kernel",
                         chunk.T.reshape(chunk.shape[1], num_heads, -1))
                else:
                    _set(params, f"{path}/{part}/bias", chunk.reshape(num_heads, -1))
        elif leaf is None:                      # bare parameter (mask_token, cls_token)
            _set(params, path, v)
        elif leaf in _STATS:
            _set(stats, f"{path}/{_STATS[leaf]}", v)
        elif leaf == "weight":
            _set(params, f"{path}/kernel" if v.ndim == 2 else f"{path}/scale",
                 v.T if v.ndim == 2 else v)
        elif leaf == "bias":
            _set(params, f"{path}/bias", v)
        else:
            raise KeyError(f"no conversion rule for leaf {name!r}")
    return params, stats


def _torch_prefix(table, head: str, names) -> str:
    """The torch module of flax path ``head``: the first rule's, or with
    ``names`` the first whose module holds one of those names."""
    if names is not None:
        for pat, tmpl in table:
            m = pat.match(head)
            if m and m.group("leaf") is None:
                prefix = tmpl.format(**{k: v for k, v in m.groupdict().items() if k != "leaf"})
                if any(n.startswith(prefix + ".") and "." not in n[len(prefix) + 1:]
                       for n in names):
                    return prefix
    return _match(table, head)[0]


def from_flax(params: Dict, batch_stats: Dict, names=None) -> Dict[str, torch.Tensor]:
    """Nested flax ``(params, batch_stats)`` of arrays -> port ``state_dict``
    (the inverse of ``to_flax``). ``names``: the torch names of the model
    to load, for a flax path that several models name apart (``increase_dim``:
    the PointCAE heads' ``increase_dim.0``, the other models'
    ``increase_dim``); without it the first rule's name."""
    inv_stats = {v: k for k, v in _STATS.items()}
    table = (_FLAX_TO_TORCH_PN2 if "pointnetv2_encoder" in params else
             _FLAX_TO_TORCH_PN if "pointnet_encoder" in params else _FLAX_TO_TORCH)
    out, qkv = {}, {}
    for tree, is_stats in ((params, False), (batch_stats, True)):
        for path, v in _flatten(tree).items():
            head, _, leaf = path.rpartition("/")
            m = _QKV_PATH.match(path)
            if m and not is_stats:              # 3DETR attention: merged below
                qkv.setdefault((m.group("mod"), m.group("leaf")), {})[m.group("part")] = v
                continue
            bare = not is_stats and _bare(path)
            if bare:                            # bare parameter (mask_token, codebook)
                out[bare] = torch.from_numpy(np.array(v))
                continue
            prefix = _torch_prefix(table, head, names)
            if is_stats:
                tleaf = inv_stats[leaf]
            elif leaf in ("kernel", "scale"):
                tleaf = "weight"
            elif leaf == "bias":
                tleaf = "bias"
            else:
                raise KeyError(f"no conversion rule for flax leaf {path!r}")
            arr = np.array(v.reshape(-1, v.shape[-1]).T if leaf == "kernel" else v)
            out[f"{prefix}.{tleaf}"] = torch.from_numpy(np.ascontiguousarray(arr))
    for (mod, leaf), parts in qkv.items():
        prefix, _ = _match(table, mod)
        if leaf == "kernel":
            arr = np.concatenate([parts[p].reshape(parts[p].shape[0], -1).T for p in _QKV])
            out[f"{prefix}.in_proj_weight"] = torch.from_numpy(np.ascontiguousarray(arr))
        else:
            arr = np.concatenate([parts[p].reshape(-1) for p in _QKV])
            out[f"{prefix}.in_proj_bias"] = torch.from_numpy(arr)
    return out
