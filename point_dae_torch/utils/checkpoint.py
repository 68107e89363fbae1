"""The ``--ckpts`` warm start of a fine-tune model from a pretrain state dict
(port of ``point_dae_tpu/utils/checkpoint.py:125-166``).

A port pretrain model names its encoder under ``MAE_encoder.`` (the
flagship) or ``dgcnn_encoder.`` (DGCNN), as the reference's torch models
do; ``strip_prefixes`` re-roots the first, so the encoder's tensors land on
the fine-tune model's top-level ``encoder``, ``pos_embed``, ``blocks`` and
``norm`` (``PointTransformer``) or on its ``dgcnn_encoder`` (``DGCNN``).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import torch


def strip_prefixes(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The released-checkpoint remap (``models/Point_MAE.py:646-655`` of the
    reference): ``module.`` always stripped; then ``MAE_encoder.`` or
    ``base_model.`` re-rooted."""
    out = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.startswith("MAE_encoder."):
            k = k[len("MAE_encoder."):]
        elif k.startswith("base_model."):
            k = k[len("base_model."):]
        out[k] = v
    return out


@torch.no_grad()
def merge_pretrained(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                     logger: Optional[str] = None) -> List[str]:
    """A strict=False load: copy every tensor whose name and shape match a
    parameter or buffer of ``model`` (BatchNorm running statistics
    included), keep the rest, and log "merged N tensors, M unmatched".
    Returns the unmatched names."""
    own = model.state_dict()
    hits, misses = 0, []
    for name, val in state_dict.items():
        if name in own and tuple(own[name].shape) == tuple(val.shape):
            own[name].copy_(val.to(own[name].dtype))
            hits += 1
        else:
            misses.append(name)
    log = logging.getLogger(logger or "point_dae_torch")
    log.info("[LOAD] merged %d tensors, %d unmatched", hits, len(misses))
    if misses:
        log.info("unmatched:\n  %s", "\n  ".join(misses[:50]))
    return misses
