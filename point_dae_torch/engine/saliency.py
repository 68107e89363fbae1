"""Input-gradient saliency maps, ``--vis_saliency`` (port of
``point_dae_tpu/engine/saliency.py``; reference
tools/runner_finetune.py:751-833): the gradient of each cloud's true-class
logit with respect to its input points, in eval mode, saved with the
points and labels for offline rendering.

The JAX package maps a per-cloud gradient over the batch. In eval mode a
cloud's logits depend on its own points only (the BatchNorms read their
running statistics), so one backward of the batch's summed true-class
logits gives every cloud's gradient at once.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import get_mesh
from ..utils.device import resolve_device
from ..utils.logger import print_log


def make_saliency_fn(model: torch.nn.Module, device=None) -> Callable:
    """``saliency(pts (B, N, 3), labels (B,)) -> d logits[label] / d pts``
    (B, N, 3)."""
    dev = resolve_device(device)

    def saliency(pts: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.eval()
        x = pts.to(dev).float().detach().requires_grad_(True)
        with torch.enable_grad():
            logits = model(x)
            picked = logits.gather(1, labels.to(dev).long()[:, None]).sum()
            (grad,) = torch.autograd.grad(picked, x)
        return grad

    return saliency


def vis_saliency_map(config, args, logger_name: str = "PointDAE", max_batches: int = 8,
                     device=None) -> str:
    """Save ``saliency_{i:03d}.npz`` (``points``, ``grads``, ``labels``) for
    the first ``max_batches`` test batches of 8 clouds, each cut to its
    first ``npoints`` points (no FPS), into ``<experiment>/saliency``.
    Returns that directory."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader
    from ..models import build_model_from_cfg
    from .finetune import _warm_start

    dev = resolve_device(device)
    dcfg = config["dataset"]
    test_set = build_dataset_from_cfg(dcfg["test"]["_base_"], dcfg["test"]["others"],
                                      device=dev)
    npoints = int(config.get("npoints", 1024))
    model = build_model_from_cfg(config["model"], device=dev, seed=0)
    if getattr(args, "ckpts", None):
        _warm_start(model, args.ckpts, logger_name)
    saliency = make_saliency_fn(model, device=dev)
    out_dir = os.path.join(args.experiment_path, "saliency")
    os.makedirs(out_dir, exist_ok=True)
    for i, batch in enumerate(DataLoader(test_set, 8, shuffle=False, drop_last=True)):
        if i >= max_batches:
            break
        pts = np.ascontiguousarray(batch["points"][:, :npoints, :3], np.float32)
        labels = np.asarray(batch["label"])
        grads = saliency(torch.from_numpy(pts), torch.from_numpy(labels)).cpu().numpy()
        if get_mesh().is_main:           # under a process group rank 0 writes
            np.savez(os.path.join(out_dir, f"saliency_{i:03d}.npz"), points=pts,
                     grads=grads, labels=labels)
    print_log(f"[Saliency] saved to {out_dir}", logger=logger_name)
    return out_dir
