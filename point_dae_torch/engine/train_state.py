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
the per-epoch schedule (CosLR, LambdaLR, StepLR, function) evaluated at
the optimizer's update count before the update, as optax's
``scale_by_schedule`` does; ``step_per_update`` k > 1 accumulates the mean
gradient of k mini-steps into one update (``TrainState``). A parameter that
the loss does not reach (MaskSurf's unused ``coarse_pred``) gets a zero
gradient, as in optax, so that its weight still decays; ``torch.optim.AdamW``
would skip it. As in the JAX
package, the schedule reads ``warmup_epochs`` and ignores the shipped
configs' ``initial_epochs`` key.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel.mesh import all_reduce_gradients, get_mesh, reduce_from_model
from ..utils.convert import flax_paths


def _no_decay(name: str, p: torch.Tensor) -> bool:
    n = name.lower()
    return p.dim() <= 1 or n.endswith("bias") or "token" in n


def make_lr_schedule(config: Dict, steps_per_epoch: float) -> Callable[[int], float]:
    """Per-step learning rate of the reference's per-epoch schedulers:
    ``CosLR``, ``LambdaLR`` (``lr * max(lr_decay ** (epoch / decay_step),
    lowest_decay)``), ``StepLR`` (``lr * gamma ** (epoch // step_size)``)
    and ``function`` (the base rate). The epoch is ``floor(step /
    steps_per_epoch)`` in f32, as the JAX package computes it:
    ``steps_per_epoch`` may be fractional (updates an epoch under
    ``step_per_update``), and f32 and f64 quotients floor apart at some
    epoch boundaries."""
    opti, sche = config["optimizer"], config["scheduler"]
    base_lr = float(opti["kwargs"]["lr"])
    kw = sche.get("kwargs", {})
    epochs = int(kw.get("epochs", config.get("max_epoch", 300)))
    stype = sche["type"]

    def epoch_of(step: int) -> int:
        return math.floor(np.float32(step) / np.float32(steps_per_epoch))

    if stype == "CosLR":
        min_lr = float(kw.get("min_lr", base_lr / 1000.0))
        warmup = int(kw.get("warmup_epochs", 0))
        warmup_lr = float(kw.get("warmup_lr", 1e-6))
        t_max = int(kw.get("t_max", epochs))

        def sched(step: int) -> float:
            e = epoch_of(step)
            if e < warmup:
                return warmup_lr + (base_lr - warmup_lr) * e / max(warmup, 1)
            t = min(max((e - warmup) / max(t_max - warmup, 1), 0.0), 1.0)
            return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t))

        return sched
    if stype == "LambdaLR":
        decay = float(kw.get("lr_decay", 0.98))
        lowest = float(kw.get("lowest_decay", 0.02))
        decay_step = float(kw.get("decay_step", 1))
        return lambda step: base_lr * max(decay ** (epoch_of(step) / decay_step), lowest)
    if stype == "StepLR":
        step_size = int(kw.get("step_size", 50))
        gamma = float(kw.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** (epoch_of(step) // step_size)
    if stype == "function":
        return lambda step: base_lr
    raise NotImplementedError(f"scheduler {stype!r}")


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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         shards: Optional[List[bool]] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on ``grads``; returns the
    global norm (a device scalar: nothing waits for the card). ``shards``
    marks the gradients of tensor-parallel shards (``parallel/mesh.py:
    shard_params``): their squared norms are summed over the model group
    (``reduce_from_model``), the whole (replicated) ones counted once, so
    every rank clips by the norm of the whole parameters."""
    shards = shards or [False] * len(grads)
    sq = [(g.float() * g.float()).sum() for g in grads]
    whole = [q for q, s in zip(sq, shards) if not s]
    split = [q for q, s in zip(sq, shards) if s]
    total = torch.stack(whole).sum()
    if split:
        total = total + reduce_from_model(torch.stack(split).sum(), get_mesh())
    norm = torch.sqrt(total)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class TrainState:
    """The model, its optimizer and schedule, the global-norm clip (None:
    no clipping), ``every_k`` (``step_per_update``) and the count of
    optimizer updates, ``step``. ``schedule`` is the rate at a mini-batch
    (what a run logs); ``update_schedule`` the rate at an update, which
    counts ``steps_per_epoch / every_k`` updates an epoch (the same
    function when ``every_k`` is 1).

    With ``every_k`` k > 1, as ``optax.MultiSteps`` wraps the JAX
    package's whole chain: each mini-step's gradients enter a running mean
    over the window (``acc + (g - acc) / (i + 1)``, optax's), the parameters
    stay as they are, and the k-th mini-step applies one update from the
    mean, clipped first. ``mini_step`` is the place in the window. A
    checkpoint keeps ``step`` but not a window's partial mean: a resumed
    run starts a new window."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 grad_norm_clip: Optional[float] = None, every_k: int = 1,
                 update_schedule: Optional[Callable[[int], float]] = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.update_schedule = update_schedule or schedule
        self.grad_norm_clip = float(grad_norm_clip) if grad_norm_clip else None
        self.every_k = int(every_k)
        self.step = 0
        self.mini_step = 0
        self.grad_norm: Optional[torch.Tensor] = None   # the last clip's norm
        self._mean: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, model, config, steps_per_epoch: float,
               grad_norm_clip: Optional[float] = None) -> "TrainState":
        k = int(config.get("step_per_update", 1))
        opt, sched = build_optimizer(config, model, steps_per_epoch)
        # the exact rational updates an epoch: a window spans epoch boundaries
        upd = sched if k == 1 else make_lr_schedule(config, max(steps_per_epoch / k, 1e-9))
        return cls(model, opt, sched, grad_norm_clip=grad_norm_clip, every_k=k,
                   update_schedule=upd)

    def zero_grad(self) -> None:
        """Drop the gradient of every parameter of the model, the frozen
        ones too: they are outside the optimizer's groups, so its own
        ``zero_grad`` would leave their gradients to add up across steps
        and grow the clip's norm."""
        self.model.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _window(self) -> bool:
        """Take this mini-step's gradients (a missing one as zeros) into
        the window's running mean; at the window's last mini-step put the
        mean in ``.grad`` and return True."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        i = self.mini_step
        if i == 0:
            self._mean = [g.clone() for g in grads]
        else:
            for acc, g in zip(self._mean, grads):
                acc.add_((g - acc) / (i + 1))
        self.mini_step = (i + 1) % self.every_k
        if self.mini_step:
            return False
        for p, acc in zip(params, self._mean):
            p.grad = acc
        self._mean = None
        return True

    def apply_gradients(self) -> None:
        """One AdamW update from the gradients in ``.grad`` (a missing one
        taken as zeros), clipped first when ``grad_norm_clip`` is set by
        their norm over every parameter of the model, at each group's
        scale of the learning rate of the current update; then the update
        count advances. Under ``every_k`` k > 1 the gradients join the
        window's mean, and only its k-th mini-step updates. Under a process
        group (``parallel/mesh.py:get_mesh()``) each gradient is first
        replaced by its mean over the data axis's ranks; under a 2-D mesh
        the clip's norm is the whole parameters' (``clip_by_global_norm_``)."""
        all_reduce_gradients([p for p in self.model.parameters() if p.requires_grad],
                             get_mesh())
        if self.every_k > 1 and not self._window():
            return
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_norm_clip is not None:
            clipped = [p for p in self.model.parameters() if p.grad is not None]
            grads = [p.grad for p in clipped]
            shards = [getattr(p, "tp_dim", None) is not None for p in clipped]
            self.grad_norm = clip_by_global_norm_(grads, self.grad_norm_clip, shards)
        lr = self.update_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        self.step += 1
