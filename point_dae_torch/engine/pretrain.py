"""The DAE pretrain step (port of ``point_dae_tpu/engine/pretrain.py:43-160``).

One step: augment and resample the raw clouds on the device, run the model
forward, backward, one AdamW update; the BatchNorm running statistics
move during the forward, as flax's mutable ``batch_stats`` do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..data.corruptions import CloudCorruptDraws, augment_batch, corrupt_batch
from ..models import build_model_from_cfg
from ..models.common import DropoutDraws
from ..models.transformer import ModelDraws
from ..ops.geometry import resample_batch
from ..utils.config import propagate_corrupt_type
from ..utils.device import resolve_device
from .train_state import TrainState


@dataclass
class PipelineDraws:
    """The pipeline's draws: ``clean`` (B, npoints) indexes the raw clouds;
    ``corrupted`` (B, npoints) indexes the corrupted clouds, or, when the
    corruption returns a validity mask, ranks into each cloud's valid
    subset; ``corrupt`` holds the cloud corruptions' own draws (one entry
    a ``corrupt_type`` position) and ``augment`` the augmentations' (one a
    ``aug_type`` position)."""
    corrupted: torch.Tensor
    clean: torch.Tensor
    corrupt: Optional[CloudCorruptDraws] = None
    augment: Optional[list] = None


@dataclass
class StepDraws:
    """``model``: the model's own draws, a ``ModelDraws`` for the
    transformer models, the list of ``DropoutDraws`` of its in-model
    dropouts for a DGCNN DAE; None draws them from the generator."""
    pipeline: PipelineDraws
    model: Optional[Union[ModelDraws, Sequence[DropoutDraws]]] = None


def device_pipeline(raw: torch.Tensor, aug_type: Sequence[str],
                    corrupt_type: Sequence[str], npoints: int,
                    draws: Optional[PipelineDraws] = None,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Nraw, C) raw clouds -> (corrupted (B, npoints, 3), clean
    (B, npoints, C)): augment xyz, corrupt the full cloud (into a buffer of
    ``corruption_capacity`` rows when a family adds points), then resample
    both streams independently, with replacement (the corrupted one from
    its valid subset when the corruption masks points out). Normals
    (columns 3:) ride along with the clean sample."""
    dev = resolve_device(device)
    raw = raw.to(dev)
    augment = corrupt = corrupted = clean = None      # drawn from the generator
    if draws is not None:
        augment, corrupt = draws.augment, draws.corrupt
        corrupted, clean = draws.corrupted, draws.clean
    xyz = augment_batch(raw[..., :3], aug_type, draws=augment, generator=generator)
    full = torch.cat([xyz, raw[..., 3:]], dim=-1)
    outs, mask = corrupt_batch(xyz, corrupt_type, draws=corrupt, generator=generator)
    return (resample_batch(outs, mask, npoints, draws=corrupted, generator=generator),
            resample_batch(full, None, npoints, draws=clean, generator=generator))


def compute_loss(loss_type: str, loss_xyz, loss_normal, normal_weight: float,
                 gradual_weight: float):
    """The reference runner's loss-type switch."""
    if loss_type == "xyz":
        return loss_xyz
    if loss_type == "normal":
        return normal_weight * loss_normal
    if loss_type == "xyznormal":
        return loss_xyz + normal_weight * loss_normal
    if loss_type in ("xyznormal_gradual", "xyznormal_warm"):
        return loss_xyz + normal_weight * loss_normal * gradual_weight
    raise NotImplementedError(loss_type)


def init_model(config, seed: int = 0, device=None) -> torch.nn.Module:
    """The configured model with weights drawn from ``seed``; an unset
    ``model.corrupt_type`` takes the train dataset's first, as a pretrain
    run's config load does (``utils/config.py:propagate_corrupt_type``)."""
    return build_model_from_cfg(propagate_corrupt_type(config)["model"], device=device,
                                seed=seed)


def make_train_step(model: torch.nn.Module, config, device=None) -> Callable:
    """Build the pretrain step. Signature:
    ``step(state, raw (B, Nraw, C), generator=None, gradual_weight=0.0,
    draws=None) -> {"loss_xyz", "loss_normal"}`` (device tensors; nothing
    waits for the card). ``draws`` (a ``StepDraws``) replaces every random
    draw of the step; otherwise they come from ``generator``."""
    dev = resolve_device(device)
    d = config["dataset"]["train"]["others"]
    aug_type = tuple(d.get("aug_type", ("norm",)))
    corrupt_type = tuple(d.get("corrupt_type", ("clean",)))
    npoints = int(d.get("npoints", 1024))
    loss_type = config.get("loss_type", "xyz")
    normal_weight = float(config.get("normal_weight", 1.0))
    if config.get("bnmscheduler") is not None:
        raise NotImplementedError("bnmscheduler is not ported yet")

    def step(state: TrainState, raw: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             gradual_weight: float = 0.0, draws: Optional[StepDraws] = None):
        corrupted, clean = device_pipeline(
            raw, aug_type, corrupt_type, npoints,
            draws=None if draws is None else draws.pipeline,
            generator=generator, device=dev)
        model.train()
        loss_xyz, loss_normal = model(corrupted, clean,
                                      draws=None if draws is None else draws.model,
                                      generator=generator)
        loss = compute_loss(loss_type, loss_xyz, loss_normal, normal_weight,
                            gradual_weight)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return {"loss_xyz": loss_xyz.detach(), "loss_normal": loss_normal.detach()}

    return step
