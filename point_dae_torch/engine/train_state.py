"""Optimizer, schedule and train state (port of
``point_dae_tpu/engine/train_state.py:26-160`` for ``optimizer.part: all``).

With ``grad_norm_clip`` the gradients are clipped by their global norm
first, in optax's form (``clip_by_global_norm``): left as they are when
``norm < max``, else replaced by ``(g / norm) * max``, with no epsilon.

AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay, skipped for
parameters with ndim <= 1, names ending in ``bias`` or containing
``token`` (the reference's ``add_weight_decay``). Parameters whose name
contains ``teacher`` (the frozen teacher of ``MaskFeat_dgcnn``) are left
out of the optimizer: no update and no weight decay, as the JAX package's
``set_to_zero`` label gives them. The learning rate follows
the per-epoch CosLR schedule evaluated at the optimizer's step count
before the update, as optax's ``scale_by_schedule`` does. As in the JAX
package, the schedule reads ``warmup_epochs`` and ignores the shipped
configs' ``initial_epochs`` key.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch


def _no_decay(name: str, p: torch.Tensor) -> bool:
    n = name.lower()
    return p.dim() <= 1 or n.endswith("bias") or "token" in n


def make_lr_schedule(config: Dict, steps_per_epoch: float) -> Callable[[int], float]:
    """Per-step learning rate of the reference's per-epoch CosLR."""
    opti, sche = config["optimizer"], config["scheduler"]
    base_lr = float(opti["kwargs"]["lr"])
    kw = sche.get("kwargs", {})
    epochs = int(kw.get("epochs", config.get("max_epoch", 300)))
    if sche["type"] != "CosLR":
        raise NotImplementedError(f"scheduler {sche['type']!r} is not ported yet")
    min_lr = float(kw.get("min_lr", base_lr / 1000.0))
    warmup = int(kw.get("warmup_epochs", 0))
    warmup_lr = float(kw.get("warmup_lr", 1e-6))
    t_max = int(kw.get("t_max", epochs))

    def sched(step: int) -> float:
        e = math.floor(step / steps_per_epoch)
        if e < warmup:
            return warmup_lr + (base_lr - warmup_lr) * e / max(warmup, 1)
        t = min(max((e - warmup) / max(t_max - warmup, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return sched


def build_optimizer(config: Dict, model: torch.nn.Module, steps_per_epoch: float):
    """(AdamW over the model's parameters in decay / no-decay groups,
    schedule)."""
    opti = config["optimizer"]
    if opti["type"] != "AdamW":
        raise NotImplementedError(opti["type"])
    if opti.get("part", "all") != "all":
        raise NotImplementedError(f"optimizer.part {opti.get('part')!r} is not ported yet")
    if int(config.get("step_per_update", 1)) != 1:
        raise NotImplementedError("step_per_update > 1 is not ported yet")
    wd = float(opti["kwargs"].get("weight_decay", 0.05))
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if "teacher" in name.lower():
            continue
        (no_decay if _no_decay(name, p) else decay).append(p)
    sched = make_lr_schedule(config, steps_per_epoch)
    opt = torch.optim.AdamW([{"params": decay, "weight_decay": wd},
                             {"params": no_decay, "weight_decay": 0.0}],
                            lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    return opt, sched


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on ``grads``; returns the
    global norm (a device scalar: nothing waits for the card)."""
    norm = torch.sqrt(torch.stack([(g.float() * g.float()).sum() for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class TrainState:
    """The model, its optimizer and schedule, the global-norm clip (None:
    no clipping) and the step count."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 grad_norm_clip: Optional[float] = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_norm_clip = float(grad_norm_clip) if grad_norm_clip else None
        self.step = 0

    @classmethod
    def create(cls, model, config, steps_per_epoch: float,
               grad_norm_clip: Optional[float] = None) -> "TrainState":
        return cls(model, *build_optimizer(config, model, steps_per_epoch),
                   grad_norm_clip=grad_norm_clip)

    def apply_gradients(self) -> None:
        """One AdamW update from the gradients in ``.grad`` (clipped first
        when ``grad_norm_clip`` is set), at the learning rate of the
        current step; then the step count advances."""
        if self.grad_norm_clip is not None:
            grads = [p.grad for g in self.optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_norm_clip)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
