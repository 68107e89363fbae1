"""Optimizer, schedule and train state (port of
``point_dae_tpu/engine/train_state.py:26-189``).

With ``grad_norm_clip`` the gradients are clipped by their global norm
first, in optax's form (``clip_by_global_norm``): left as they are when
``norm < max``, else replaced by ``(g / norm) * max``, with no epsilon. As
optax clips before its ``multi_transform``, the norm spans every parameter
of the model, frozen ones included (a parameter without a gradient counts
as zeros, as the frozen teacher's stop-gradient zeros do in JAX).

``optimizer.part`` selects what trains, by substring tests on each
parameter's flax path in the JAX package (its name through the weight
bridge, ``utils/convert.py:flax_paths``), lower-cased:

- ``all``: everything but a frozen ``teacher`` (``MaskFeat_dgcnn``,
  ``MaskFeat_transformer``);
- ``only_new``: the paths containing ``cls``; the rest is frozen;
- ``diff_lr``: the ``cls`` paths at the schedule's rate, the rest
  (pretrained) at 0.1 times it, its decoupled weight decay scaled alike
  (optax's adamw multiplies the decay by the rate);
- ``decoder``: the paths containing ``decoder_pos_embed``, ``mae_decoder``
  or ``increase_dim``.

A frozen parameter keeps ``requires_grad`` (its gradient enters the clip's
norm) but stays out of the AdamW groups: no update and no weight decay, as
optax's ``set_to_zero`` gives. So a step clears the gradients of the whole
model (``TrainState.zero_grad``), not only of the optimizer's parameters.

AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay, skipped for
parameters with ndim <= 1, names ending in ``bias`` or containing
``token`` (the reference's ``add_weight_decay``). The learning rate follows
the per-epoch CosLR schedule evaluated at the optimizer's step count
before the update, as optax's ``scale_by_schedule`` does. A parameter that
the loss does not reach (MaskSurf's unused ``coarse_pred``) gets a zero
gradient, as in optax, so that its weight still decays; ``torch.optim.AdamW``
would skip it. As in the JAX
package, the schedule reads ``warmup_epochs`` and ignores the shipped
configs' ``initial_epochs`` key.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from ..utils.convert import flax_paths


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


DECODER_KEYS = ("decoder_pos_embed", "mae_decoder", "increase_dim")


def part_label(part: str, path: str) -> str:
    """The JAX package's label of a parameter under ``optimizer.part``:
    ``train`` (the schedule's rate), ``pretrained`` (0.1 times it) or
    ``frozen``. ``path`` is its flax path."""
    p = path.lower()
    if part == "all":
        return "frozen" if "teacher" in p else "train"
    if part == "only_new":
        return "train" if "cls" in p else "frozen"
    if part == "diff_lr":
        return "train" if "cls" in p else "pretrained"
    if part == "decoder":
        return "train" if any(k in p for k in DECODER_KEYS) else "frozen"
    raise NotImplementedError(f"optimizer.part {part!r}")


LR_SCALE = {"train": 1.0, "pretrained": 0.1}


def build_optimizer(config: Dict, model: torch.nn.Module, steps_per_epoch: float):
    """(AdamW over the parameters that ``optimizer.part`` trains, in groups
    by learning-rate scale and decay, schedule). Each group's ``lr_scale``
    multiplies the schedule's rate."""
    opti = config["optimizer"]
    if opti["type"] != "AdamW":
        raise NotImplementedError(opti["type"])
    part = opti.get("part", "all")
    if int(config.get("step_per_update", 1)) != 1:
        raise NotImplementedError("step_per_update > 1 is not ported yet")
    wd = float(opti["kwargs"].get("weight_decay", 0.05))
    # every registered model has bridge rules but the bare DiscreteVAE
    # tokenizer, which trains only inside Point_dVAE
    named = list(model.named_parameters())
    paths = flax_paths([n for n, _ in named])
    groups: Dict[tuple, list] = {}
    for name, p in named:
        label = part_label(part, paths[name])
        if label != "frozen":
            groups.setdefault((label, not _no_decay(name, p)), []).append(p)
    sched = make_lr_schedule(config, steps_per_epoch)
    # a part that trains nothing (only_new on a model without a cls head)
    # keeps one empty group: torch refuses an optimizer without groups
    opt = torch.optim.AdamW(
        [{"params": ps, "weight_decay": wd if decays else 0.0, "lr_scale": LR_SCALE[label]}
         for (label, decays), ps in sorted(groups.items(), key=lambda kv: (
             kv[0][0] != "train", not kv[0][1]))] or [{"params": []}],
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

    def zero_grad(self) -> None:
        """Drop the gradient of every parameter of the model, the frozen
        ones too: they are outside the optimizer's groups, so its own
        ``zero_grad`` would leave their gradients to add up across steps
        and grow the clip's norm."""
        self.model.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One AdamW update from the gradients in ``.grad`` (a missing one
        taken as zeros), clipped first when ``grad_norm_clip`` is set by
        their norm over every parameter of the model, at each group's
        scale of the learning rate of the current step; then the step
        count advances."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_norm_clip is not None:
            clip_by_global_norm_([p.grad for p in self.model.parameters()
                                  if p.grad is not None], self.grad_norm_clip)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        self.step += 1
