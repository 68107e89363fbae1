"""The SO(3) rotation-robustness protocol, ``--so3_rotation`` (port of
``point_dae_tpu/engine/rotation.py``; reference
tools/runner_finetune.py:322-564): fine-tune a classifier under z-axis or
full SO(3) rotations and test under either (z2z, z2so3, so32so3; configs
``finetune_modelnet_rotation_*``).

A train step rotates each cloud (``rotate_batch``), FPS-resamples it as the
fine-tune step does (``engine/finetune.py:fps_resample``), runs the model
in train mode and takes the plain cross-entropy: the configs' ``smooth``
is not read here, as in the JAX package. The gradients are clipped by the
config's ``grad_norm_clip`` before the AdamW update. The eval step rotates,
FPS-samples to ``npoints`` and runs the eval forward. Random draws are
inputs: ``RotationDraws`` or a ``torch.Generator``. Under a process group
(``parallel/mesh.py``) the draws are the global batch's, each rank keeps
its rows, and validation splits each padded batch over the ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..data.corruptions import rotate_points, rotation_matrix, sample_rotation
from ..models.common import ClsDraws
from ..ops.geometry import furthest_point_sample, gather_points
from ..parallel.mesh import (get_mesh, mean_over_ranks, replicate, row_drawer, sharded_eval,
                             train_loader)
from ..utils.device import resolve_device
from ..utils.logger import print_log
from .finetune import (_warm_start, cross_entropy, fps_resample, pad_to_batch, point_all,
                       sample_subset)
from .train_state import TrainState


@dataclass
class RotationDraws:
    """One train step's draws: the rotation ``angles`` (``sample_rotation``;
    None for mode ``none``), the resample's ``subset`` (B, npoints) and the
    model's own (head dropout, stochastic depth)."""
    angles: Optional[torch.Tensor] = None
    subset: Optional[torch.Tensor] = None
    model: Optional[ClsDraws] = None


def rotate_batch(pts: torch.Tensor, mode: str, angles: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each cloud x -> x @ R (``rotate_points``): ``z`` a z rotation in
    +-pi, ``so3`` Rz Ry Rx of Euler angles in +-pi, ``none`` unrotated;
    ``angles`` drawn from ``generator`` when not given."""
    if mode == "none":
        return pts
    if angles is None:
        angles = sample_rotation(mode, pts.shape[0], generator, pts.device)
    return rotate_points(pts, rotation_matrix(mode, angles))


def sample_rotation_draws(model: torch.nn.Module, mode: str, npoints: int, batch: int,
                          n: int, generator: Optional[torch.Generator], device
                          ) -> RotationDraws:
    """Every draw of one train step for ``batch`` clouds of ``n`` points, in
    the order the step takes them itself: the rotation, the resample's
    subset, the model's own."""
    angles = None if mode == "none" else sample_rotation(mode, batch, generator, device)
    keep = point_all(npoints, n)
    subset = sample_subset(batch, keep, npoints, generator, device) if keep > npoints else None
    sample = getattr(model, "sample_draws", None)
    return RotationDraws(angles, subset,
                         None if sample is None else sample(batch, generator, device))


def protocol(config, mode_arg: Optional[str]):
    """(train mode, test mode): ``--mode z2z|z2so3|so32so3`` first, then the
    config's ``rotation`` dict, else z2so3."""
    if mode_arg in ("z2z", "z2so3", "so32so3"):
        train_mode, test_mode = mode_arg.split("2")
        return train_mode, test_mode
    rot = config.get("rotation", {"train": "z", "test": "so3"})
    return rot.get("train", "z"), rot.get("test", "so3")


def make_rotation_train_step(model: torch.nn.Module, config, train_mode: str,
                             device=None) -> Callable:
    """``step(state, pts (B, N, C), labels (B,), generator=None, draws=None)
    -> {"loss", "acc", "logits"}`` (device tensors; acc a fraction)."""
    dev = resolve_device(device)
    npoints = int(config.get("npoints", 1024))
    step_draws = row_drawer(lambda b, n, g: sample_rotation_draws(model, train_mode, npoints,
                                                                  b, n, g, dev))

    def step(state: TrainState, pts: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[RotationDraws] = None):
        if draws is None:
            draws = step_draws(pts.shape[0], pts.shape[1], generator)
        pts = pts.to(dev)[..., :3]
        labels = labels.to(dev).long()
        pts = rotate_batch(pts, train_mode, draws.angles, generator)
        pts = fps_resample(pts, npoints, draws.subset, generator)
        model.train()
        logits = model(pts, draws=draws.model, generator=generator)
        loss = cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        state.zero_grad()
        loss.backward()
        state.apply_gradients()
        out = mean_over_ranks({"loss": loss.detach(), "acc": acc.detach()})
        return dict(out, logits=logits.detach())

    return step


def make_rotation_eval_step(model: torch.nn.Module, config, test_mode: str,
                            device=None) -> Callable:
    """``step(pts (B, N, C), generator=None, angles=None) -> logits``:
    rotate, FPS to ``npoints``, the eval forward."""
    dev = resolve_device(device)
    npoints = int(config.get("npoints", 1024))

    @torch.no_grad()
    def step(pts: torch.Tensor, generator: Optional[torch.Generator] = None,
             angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        pts = rotate_batch(pts.to(dev)[..., :3], test_mode, angles, generator)
        pts = gather_points(pts, furthest_point_sample(pts, npoints))
        model.eval()
        return model(pts)

    return step


def run_net_rotation(config, args, logger_name: str = "PointDAE", device=None):
    """Train under the train rotation, validate each epoch under the test
    rotation (the tail batch padded to ``total_bs``), write ``ckpt-last``
    every epoch. Returns {"best_acc", "state"}."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader
    from ..models import build_model_from_cfg
    from ..utils.checkpoint import save_checkpoint

    dev = resolve_device(device)
    seed = int(getattr(args, "seed", 0))
    train_mode, test_mode = protocol(config, getattr(args, "mode", None))
    dcfg = config["dataset"]
    train_set = build_dataset_from_cfg(dcfg["train"]["_base_"], dcfg["train"]["others"],
                                       device=dev)
    val_set = build_dataset_from_cfg(dcfg["val"]["_base_"], dcfg["val"]["others"],
                                     device=dev)
    total_bs = int(config.get("total_bs", 32))
    mesh = get_mesh()
    loader = train_loader(train_set, total_bs, seed, mesh)
    model = build_model_from_cfg(config["model"], device=dev, seed=seed)
    if getattr(args, "ckpts", None):
        _warm_start(model, args.ckpts, logger_name)
    replicate(mesh, model)
    state = TrainState.create(model, config, max(len(loader), 1),
                              config.get("grad_norm_clip"))
    train_step = make_rotation_train_step(model, config, train_mode, device=dev)
    eval_step = make_rotation_eval_step(model, config, test_mode, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    best = 0.0
    for epoch in range(int(config.get("max_epoch", 300)) + 1):
        loader.set_epoch(epoch)
        step_metrics = [train_step(state, torch.from_numpy(np.asarray(b["points"], np.float32)),
                                   torch.from_numpy(np.asarray(b["label"])),
                                   generator=generator) for b in loader]
        if step_metrics:
            got = torch.stack([torch.stack([m["loss"], m["acc"]])
                               for m in step_metrics]).mean(0).tolist()
            print_log(f"[Training] EPOCH: {epoch} loss = {got[0]:.5f} acc = {got[1]:.5f}",
                      logger=logger_name)
        correct = total = 0
        for batch in DataLoader(val_set, total_bs, shuffle=False, drop_last=False):
            pts = np.asarray(batch["points"][..., :3], np.float32)
            labels = np.asarray(batch["label"]).reshape(-1)
            n = pts.shape[0]
            padded = torch.from_numpy(pad_to_batch(pts, total_bs))
            if test_mode == "none":
                logits = sharded_eval(eval_step, padded)
            else:       # the padded batch's angles, so each rank rotates its rows
                angles = sample_rotation(test_mode, total_bs, generator, dev)
                logits = sharded_eval(lambda p, a: eval_step(p, angles=a), padded, angles)
            correct += int((logits[:n].argmax(-1).cpu().numpy() == labels).sum())
            total += n
        acc = 100.0 * correct / max(total, 1)
        best = max(best, acc)
        print_log(f"[Validation] EPOCH: {epoch}  acc = {acc:.4f} "
                  f"({train_mode}2{test_mode}) best = {best:.4f}", logger=logger_name)
        save_checkpoint(args.experiment_path, "ckpt-last", state, epoch, best,
                        logger=logger_name)
    return {"best_acc": best, "state": state}
