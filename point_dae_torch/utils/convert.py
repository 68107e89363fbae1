"""Weight bridge between the port's ``state_dict`` and the JAX package's
flax ``(params, batch_stats)`` trees.

Port parameters carry the reference's torch names (the names that
``point_dae_tpu/utils/convert_torch.py`` translates), so one table maps
each torch module prefix to its flax path. Leaves translate as the
reference converter does: a 2-D ``weight`` is a dense kernel stored
``(out, in)`` in torch and ``(in, out)`` in flax, a 1-D ``weight`` is a norm
``scale``, and the BatchNorm ``running_mean``/``running_var`` buffers are the
flax ``batch_stats`` leaves ``mean``/``var``.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# (torch module prefix, flax path); {i} is a block index
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
for _torch, _flax in (("MAE_encoder.blocks.blocks.{i}", "MAE_encoder/blocks/block{i}"),
                      ("MAE_decoder.blocks.{i}", "MAE_decoder/block{i}")):
    for _t, _f in (("norm1", "norm1"), ("attn.qkv", "attn/qkv"),
                   ("attn.proj", "attn/proj"), ("norm2", "norm2"),
                   ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
        _RULES.append((f"{_torch}.{_t}", f"{_flax}/{_f}"))

# MaskFeat_dgcnn: its DGCNN teacher and the 1024-wide head
for _i in range(1, 5):
    _RULES += [(f"teacher.conv{_i}.0", f"teacher/ec{_i}/conv"),
               (f"teacher.bn{_i}", f"teacher/ec{_i}/bn")]
_RULES += [("teacher.conv5.0", "teacher/conv5"), ("teacher.bn5", "teacher/bn5"),
           ("increase_dim", "increase_dim")]

# the MaskSurf family's second head (convert_torch._MASKSURF_RULES)
_RULES.append(("increase_dim2", "increase_dim2"))

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
for _t, _f in (("norm1", "norm1"), ("attn.qkv", "attn/qkv"), ("attn.proj", "attn/proj"),
               ("norm2", "norm2"), ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
    _RULES.append((f"blocks.blocks.{{i}}.{_t}", f"blocks/block{{i}}/{_f}"))

# the two fine-tune heads share their torch names at other indices, so a
# state_dict takes the DGCNN head's rules when it holds a DGCNN encoder
_TRANSFORMER_HEAD = [(f"cls_head_finetune.{i}", f"cls_head_finetune/{f}")
                     for i, f in ((0, "fc0"), (1, "bn0"), (4, "fc1"), (5, "bn1"),
                                  (8, "cls"))]
_DGCNN_HEAD = [(f"cls_head_finetune.{i}", f"cls_head/{f}")
               for i, f in ((0, "fc1"), (1, "bn1"), (3, "fc2"), (4, "bn2"), (7, "cls"))]

_STATS = {"running_mean": "mean", "running_var": "var"}


def _pattern(fmt: str, sep: str) -> re.Pattern:
    esc = re.escape(fmt).replace(r"\{i\}", r"(?P<i>\d+)")
    return re.compile(f"^{esc}(?:{re.escape(sep)}(?P<leaf>[A-Za-z_]+))?$")


_TORCH_TO_FLAX = {family: [(_pattern(t, "."), f) for t, f in _RULES + rules]
                  for family, rules in (("transformer", _TRANSFORMER_HEAD),
                                        ("dgcnn", _DGCNN_ENCODER + _DGCNN_HEAD),
                                        ("dgcnn_partseg", _DGCNN_PARTSEG_ENCODER))}
_FLAX_TO_TORCH = [(_pattern(f, "/"), t) for t, f in _RULES + _TRANSFORMER_HEAD
                  + _DGCNN_ENCODER + _DGCNN_HEAD + _DGCNN_PARTSEG_ENCODER]


def _family(state_dict) -> str:
    """Which torch-name table a state dict takes: the two DGCNN encoders
    and the two fine-tune heads reuse torch names at other flax paths."""
    if "dgcnn_encoder.conv6.0.weight" in state_dict:
        return "dgcnn_partseg"
    if any(k.startswith("dgcnn_encoder.") for k in state_dict):
        return "dgcnn"
    return "transformer"


def _match(table, name: str):
    for pat, tmpl in table:
        m = pat.match(name)
        if m:
            return tmpl.format(i=m.group("i")) if "{i}" in tmpl else tmpl, \
                m.group("leaf")
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


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Port ``state_dict`` -> nested ``(params, batch_stats)`` of numpy
    arrays (copies: later updates of the model leave them as they are),
    laid out as the JAX package's models initialise them."""
    params, stats = {}, {}
    table = _TORCH_TO_FLAX[_family(state_dict)]
    for name, t in state_dict.items():
        v = t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t)
        path, leaf = _match(table, name)
        if leaf is None:                        # bare parameter (mask_token, cls_token)
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


def from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """Nested flax ``(params, batch_stats)`` of arrays -> port ``state_dict``
    (the inverse of ``to_flax``)."""
    inv_stats = {v: k for k, v in _STATS.items()}
    out = {}
    for tree, is_stats in ((params, False), (batch_stats, True)):
        for path, v in _flatten(tree).items():
            head, _, leaf = path.rpartition("/")
            bare = not is_stats and _bare(path)
            if bare:                            # bare parameter (mask_token, codebook)
                out[bare] = torch.from_numpy(np.array(v))
                continue
            prefix, _ = _match(_FLAX_TO_TORCH, head)
            if is_stats:
                tleaf = inv_stats[leaf]
            elif leaf in ("kernel", "scale"):
                tleaf = "weight"
            elif leaf == "bias":
                tleaf = "bias"
            else:
                raise KeyError(f"no conversion rule for flax leaf {path!r}")
            arr = np.array(v.T if leaf == "kernel" else v)
            out[f"{prefix}.{tleaf}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
