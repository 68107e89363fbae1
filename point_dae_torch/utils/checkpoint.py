"""Checkpoint files: save, resume, load, key diffs, and the ``--ckpts`` warm
start (port of ``point_dae_tpu/utils/checkpoint.py:31-166``).

A checkpoint is a ``torch.save`` file in the reference's ``.pth`` layout
(the reference's ``save_checkpoint``): ``base_model`` (the model's state dict under
the reference's torch names), ``optimizer`` (the AdamW state dict), ``step``
(the optimizer's step count, which places the CosLR schedule), ``epoch`` and
``best_metric``. A run writes ``ckpt-best.pth`` and ``ckpt-last.pth`` (a
part-segmentation run ``best_model.pth``) into its experiment directory.
``load_params`` reads such a file or a released reference ``.pth``
(``base_model`` or ``model`` or a bare state dict, ``module.`` stripped);
the JAX package's Orbax directories are not read.

A port pretrain model names its encoder under ``MAE_encoder.`` (the
flagship) or ``dgcnn_encoder.`` (DGCNN), as the reference's torch models
do; ``strip_prefixes`` re-roots the first, so the encoder's tensors land on
the fine-tune model's top-level ``encoder``, ``pos_embed``, ``blocks`` and
``norm`` (``PointTransformer``) or on its ``dgcnn_encoder`` (``DGCNN``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import (barrier, gather_optimizer_state, gather_params, get_mesh,
                             shard_optimizer_state, shard_state)
from .logger import print_log


def _file(experiment_path: str, name: str) -> str:
    return os.path.abspath(os.path.join(experiment_path, f"{name}.pth"))


def save_checkpoint(experiment_path: Optional[str], name: str, state, epoch: int,
                    best_metric: float, logger: Optional[str] = None) -> None:
    """Write ``<experiment_path>/<name>.pth`` (the reference's save_checkpoint) from
    a ``TrainState``; the file is replaced whole, never left half written.
    Under a process group rank 0 writes and the others wait for it at a
    barrier. Under a 2-D mesh the parameters and AdamW's moments of a
    tensor-parallel shard are gathered whole first (``parallel/mesh.py:
    gather_params``), so the file has the one-process layout, and
    ``resume_checkpoint`` cuts it to the model's shards again."""
    if experiment_path is None:
        return
    mesh = get_mesh()
    weights = gather_params(mesh, state.model)      # collective over the model group
    moments = gather_optimizer_state(mesh, state.model, state.optimizer)
    if not mesh.is_main:
        barrier(mesh)
        return
    path = _file(experiment_path, name)
    payload = {
        "base_model": {k: v.detach().cpu() for k, v in weights.items()},
        "optimizer": moments,
        "step": int(state.step),
        "epoch": int(epoch),
        "best_metric": float(best_metric),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    print_log(f"Saved checkpoint at {path}", logger=logger)
    barrier(mesh)


def resume_checkpoint(experiment_path: str, state, name: str = "ckpt-last",
                      logger: Optional[str] = None) -> Tuple[Any, int, float]:
    """Resume from ``<name>.pth`` (the reference's resume_model): the weights,
    the optimizer's moments and the step count. Returns (state, start_epoch,
    best_metric); (state, 0, 0.0) when there is no such file."""
    path = _file(experiment_path, name)
    if not os.path.exists(path):
        print_log(f"[RESUME] no checkpoint at {path}", logger=logger)
        return state, 0, 0.0
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    mesh = get_mesh()     # a tensor-parallel model takes its shards of the whole tensors
    state.model.load_state_dict(shard_state(mesh, state.model, ckpt["base_model"]))
    state.optimizer.load_state_dict(shard_optimizer_state(mesh, state.model, state.optimizer,
                                                          ckpt["optimizer"]))
    state.step = int(ckpt["step"])
    print_log(f"[RESUME] epoch {ckpt['epoch']} (best {ckpt['best_metric']:.4f})",
              logger=logger)
    return state, int(ckpt["epoch"]) + 1, float(ckpt["best_metric"])


def load_params(experiment_path: str, name: str = "ckpt-best") -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint file, on the CPU, ``module.`` stripped.

    Accepts (experiment_dir, name) or a checkpoint path in both arguments
    (callers pass ``--ckpts`` straight through); ``.pth`` may be left off."""
    path = name if (os.path.isabs(name) or experiment_path == name) \
        else os.path.join(experiment_path, name)
    if not os.path.exists(path) and os.path.exists(path + ".pth"):
        path += ".pth"
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory (an Orbax checkpoint of the JAX "
                         f"package?); the port reads .pth files")
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("base_model", ckpt.get("model", ckpt))
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def flatten_keys(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_keys(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def report_key_diff(expected: Dict, loaded: Dict,
                    logger: Optional[str] = None) -> Tuple[list, list]:
    """Missing/unexpected key report (utils/checkpoint.py:16-47 role)."""
    exp = set(flatten_keys(expected))
    got = set(flatten_keys(loaded))
    missing = sorted(exp - got)
    unexpected = sorted(got - exp)
    if missing:
        print_log("missing keys:\n  " + "\n  ".join(missing), logger=logger)
    if unexpected:
        print_log("unexpected keys:\n  " + "\n  ".join(unexpected), logger=logger)
    return missing, unexpected


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
    print_log(f"[LOAD] merged {hits} tensors, {len(misses)} unmatched", logger=logger)
    if misses:
        print_log("unmatched:\n  " + "\n  ".join(misses[:50]), logger=logger)
    return misses
