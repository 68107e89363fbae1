"""Classification fine-tune: the steps, the accuracy loops and the runs
(port of ``point_dae_tpu/engine/finetune.py``).

A train step resamples each cloud on the device (FPS to ``point_all``,
1200/2400/4800/8192 for npoints 1024/2048/4096/8192, then a random
``npoints`` of them without replacement), applies the configured
train-time augmentation (``none`` by default), runs the model in train
mode, takes the (smooth) cross-entropy, clips the gradients by their
global norm and makes one AdamW update; the BatchNorm running statistics
move during the forward. The eval step takes FPS to ``npoints``; the raw
eval step feeds the clouds as they are; the vote step averages the raw
logits of ``times`` draws of the train resample plus scale-and-translate.

Random draws are inputs: a step takes a ``FinetuneDraws`` (a sequence of
them for the vote step) or draws from the given ``torch.Generator``.
``run_finetune`` (reference runner_finetune.run_net) trains from a config,
validates each epoch and votes when the accuracy crosses the reference's
trigger; ``test_net`` evaluates a checkpoint, with repeated voting under
``--vote``.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.corruptions_patch import _batched_rot
from ..models.common import ClsDraws
from ..ops.geometry import furthest_point_sample, gather_points
from ..utils.device import resolve_device
from ..utils.logger import ScalarWriter, print_log
from ..utils.meters import AverageMeter
from .train_state import TrainState

POINT_ALL = {1024: 1200, 2048: 2400, 4096: 4800, 8192: 8192}
AUGS = ("none", "scale_translate", "rotate", "dg")


@dataclass
class FinetuneDraws:
    """Every random draw of one step (or of one vote draw):

    - ``subset`` (B, npoints) long: the per-cloud choice without
      replacement among the FPS picks, None when FPS goes to npoints;
    - ``aug``: the augmentation's parameters, None for ``none``:
      ``scale_translate`` (scale (B, 1, 3), shift (B, 1, 3)); ``rotate``
      (angles (B, 3) of ``R = Rz Ry Rx``); ``dg`` (z angle (B,), unit
      normal noise (B, npoints, 3));
    - ``model``: the model's own draws (head dropout, stochastic depth),
      None in eval."""
    subset: Optional[torch.Tensor] = None
    aug: Optional[tuple] = None
    model: Optional[ClsDraws] = None


def point_all(npoints: int, n: int) -> int:
    """How many points FPS keeps before the subset (``finetune.py:35,43``)."""
    return min(POINT_ALL.get(npoints, npoints), n)


def sample_subset(batch: int, n_from: int, npoints: int,
                  generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(B, npoints) long: per cloud, npoints distinct indices of n_from."""
    u = torch.rand((batch, n_from), generator=generator, device=device)
    return u.argsort(dim=1)[:, :npoints]


def fps_resample(pts: torch.Tensor, npoints: int, subset: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Train-time resample (``finetune.py:38-53``): FPS to ``point_all``,
    gather, then the per-cloud ``subset`` of npoints (drawn from
    ``generator`` when not given) when point_all > npoints."""
    keep = point_all(npoints, pts.shape[1])
    sampled = gather_points(pts, furthest_point_sample(pts[..., :3], keep))
    if keep > npoints:
        if subset is None:
            subset = sample_subset(pts.shape[0], keep, npoints, generator, pts.device)
        sampled = gather_points(sampled, subset)
    return sampled


def sample_scale_translate(batch: int, generator: Optional[torch.Generator], device,
                           lo: float = 2. / 3., hi: float = 3. / 2., trans: float = 0.2
                           ) -> tuple:
    """(scale (B, 1, 3) ~ U(lo, hi), shift (B, 1, 3) ~ U(-trans, trans))."""
    s = lo + (hi - lo) * torch.rand((batch, 1, 3), generator=generator, device=device)
    t = -trans + 2 * trans * torch.rand((batch, 1, 3), generator=generator, device=device)
    return s, t


def scale_translate(pts: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
                    ) -> torch.Tensor:
    """PointcloudScaleAndTranslate (``finetune.py:56-64``): pts * s + t."""
    return pts * scale + shift


def _sample_aug(aug: str, pts: torch.Tensor, generator) -> Optional[tuple]:
    B, dev = pts.shape[0], pts.device
    if aug == "scale_translate":
        return sample_scale_translate(B, generator, dev)
    if aug == "rotate":
        return (math.pi * (2 * torch.rand((B, 3), generator=generator, device=dev) - 1),)
    if aug == "dg":
        return (2 * math.pi * torch.rand((B,), generator=generator, device=dev),
                torch.randn(pts.shape, generator=generator, device=dev))
    return None


def augment(pts: torch.Tensor, aug: str, params: Optional[tuple]) -> torch.Tensor:
    """The train-time augmentations of ``finetune.py:116-142`` with their
    drawn parameters."""
    if aug == "scale_translate":
        return scale_translate(pts, *params)
    if aug == "rotate":       # x @ R, R = Rz Ry Rx of full-circle Euler angles
        return torch.matmul(pts, _batched_rot(params[0]))
    if aug == "dg":           # a z rotation, then clipped jitter (sigma .01, clip .02)
        ang, noise = params
        c, s = torch.cos(ang), torch.sin(ang)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        rz = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                          torch.stack([z, z, o], -1)], -2)
        return torch.einsum("bnc,bcd->bnd", pts, rz) + (0.01 * noise).clamp(-0.02, 0.02)
    return pts


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         eps: float = 0.3) -> torch.Tensor:
    """Label-smoothed cross-entropy (the reference's smooth loss, eps 0.3)."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    target = F.one_hot(labels.long(), n).float() * (1 - eps) + eps / n
    return -(target * logp).sum(-1).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def read_smooth(config) -> bool:
    """``smooth`` from the top-level key or from ``model.smoothloss``, string
    spellings included (``finetune.py:320-325``)."""
    raw = config.get("smooth", config.get("model", {}).get("smoothloss", False))
    return str(raw).lower() in ("true", "1")


def make_finetune_step(model: torch.nn.Module, config, smooth: Optional[bool] = None,
                       aug: Optional[str] = None, device=None) -> Callable:
    """Build the train step. Signature: ``step(state, pts (B, N, C), labels
    (B,), generator=None, draws=None) -> {"loss", "acc"}`` (device tensors,
    acc in percent). ``smooth`` defaults to the config's; ``aug`` to
    ``train_aug`` (default ``none``)."""
    dev = resolve_device(device)
    npoints = int(config.get("npoints", 1024))
    aug = config.get("train_aug", "none") if aug is None else aug
    if aug not in AUGS:
        raise ValueError(f"train_aug {aug!r}")
    smooth = read_smooth(config) if smooth is None else smooth
    loss_fn = smooth_cross_entropy if smooth else cross_entropy

    def step(state: TrainState, pts: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[FinetuneDraws] = None):
        draws = draws or FinetuneDraws()
        pts = pts.to(dev)[..., :3]
        labels = labels.to(dev).long()
        pts = fps_resample(pts, npoints, draws.subset, generator)
        params = draws.aug if draws.aug is not None else _sample_aug(aug, pts, generator)
        pts = augment(pts, aug, params)
        model.train()
        logits = model(pts, draws=draws.model, generator=generator)
        loss = loss_fn(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean() * 100.0
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "acc": acc.detach()}

    return step


def make_eval_step(model: torch.nn.Module, config, device=None) -> Callable:
    """``step(pts (B, N, C)) -> logits``: FPS to npoints, the eval forward."""
    dev = resolve_device(device)
    npoints = int(config.get("npoints", 1024))

    @torch.no_grad()
    def step(pts: torch.Tensor) -> torch.Tensor:
        pts = pts.to(dev)[..., :3]
        pts = gather_points(pts, furthest_point_sample(pts, npoints))
        model.eval()
        return model(pts)

    return step


def make_eval_step_raw(model: torch.nn.Module, device=None) -> Callable:
    """``step(pts) -> logits`` on the clouds as they are, with no resample
    (the ModelNet-C protocol, ``finetune.py:183-200``)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(pts: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(pts.to(dev)[..., :3])

    return step


def make_vote_step(model: torch.nn.Module, config, times: int = 10,
                   device=None) -> Callable:
    """``step(pts, generator=None, draws=None) -> logits``: the mean of the
    raw logits over ``times`` draws of FPS resample + scale-and-translate
    (``finetune.py:203-235``). ``draws``: ``times`` FinetuneDraws with
    ``subset`` and ``aug`` (scale, shift)."""
    dev = resolve_device(device)
    npoints = int(config.get("npoints", 1024))

    @torch.no_grad()
    def step(pts: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Sequence[FinetuneDraws]] = None) -> torch.Tensor:
        pts = pts.to(dev)[..., :3]
        model.eval()
        total = None
        for i in range(times):
            d = draws[i] if draws is not None else FinetuneDraws()
            p = fps_resample(pts, npoints, d.subset, generator)
            s, t = d.aug if d.aug is not None else sample_scale_translate(
                p.shape[0], generator, dev)
            logits = model(scale_translate(p, s, t))
            total = logits if total is None else total + logits
        return total / times

    return step


def pad_to_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad a short tail batch along axis 0 to ``batch_size``; callers
    slice the logits back to the true count."""
    n = arr.shape[0]
    if n >= batch_size:
        return arr
    return np.concatenate([arr, np.zeros((batch_size - n,) + arr.shape[1:], arr.dtype)])


def _accuracy(logits_of: Callable, batches: Iterable[dict], batch_size: int) -> float:
    correct = total = 0
    for batch in batches:
        pts = np.asarray(batch["points"], np.float32)
        labels = np.asarray(batch["label"]).reshape(-1)
        n = pts.shape[0]
        logits = logits_of(torch.from_numpy(pad_to_batch(pts, batch_size)))
        pred = logits[:n].argmax(-1).cpu().numpy()
        correct += int((pred == labels).sum())
        total += n
    return 100.0 * correct / max(total, 1)


def evaluate(eval_step: Callable, batches: Iterable[dict], batch_size: int) -> float:
    """Accuracy in percent over ``batches`` ({"points", "label"} of numpy
    arrays), the tail batch padded (``finetune.py:246-260``)."""
    return _accuracy(eval_step, batches, batch_size)


def vote_eval(vote_step: Callable, batches: Iterable[dict], batch_size: int,
              generator: Optional[torch.Generator] = None) -> float:
    """Voting accuracy in percent (``finetune.py:391-403``)."""
    return _accuracy(lambda p: vote_step(p, generator=generator), batches, batch_size)


def _warm_start(model: torch.nn.Module, ckpts: str, logger_name: str) -> None:
    """Merge a checkpoint's tensors into ``model`` by name and shape, a
    pretrain encoder re-rooted (``utils/checkpoint.py:strip_prefixes``)."""
    from ..utils.checkpoint import load_params, merge_pretrained, strip_prefixes

    merge_pretrained(model, strip_prefixes(load_params(ckpts, ckpts)), logger=logger_name)


def run_finetune(config, args, logger_name: str = "PointDAE", device=None):
    """The fine-tune run (runner_finetune.run_net :83-270): FPS resample,
    (smooth) cross-entropy, gradient clip, validation each epoch, voting
    under ``--vote`` when the accuracy crosses the reference's trigger
    (:254-262), ckpt-best and ckpt-last. Returns {"best_acc", "best_vote",
    "state"}."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader
    from ..models import build_model_from_cfg
    from ..utils.checkpoint import resume_checkpoint, save_checkpoint

    dev = resolve_device(device)
    seed = int(getattr(args, "seed", 0))
    dcfg = config["dataset"]
    train_set = build_dataset_from_cfg(dcfg["train"]["_base_"], dcfg["train"]["others"],
                                       device=dev)
    val_set = build_dataset_from_cfg(dcfg["val"]["_base_"], dcfg["val"]["others"],
                                     device=dev)
    total_bs = int(config.get("total_bs", 32))
    loader = DataLoader(train_set, total_bs, shuffle=True, seed=seed)

    def val_batches():
        return DataLoader(val_set, total_bs, shuffle=False, drop_last=False)

    max_epoch = int(config.get("max_epoch", 300))
    model = build_model_from_cfg(config["model"], device=dev, seed=seed)
    if getattr(args, "ckpts", None):
        _warm_start(model, args.ckpts, logger_name)
    state = TrainState.create(model, config, max(len(loader), 1),
                              config.get("grad_norm_clip"))
    train_step = make_finetune_step(model, config, device=dev)
    eval_step = make_eval_step(model, config, device=dev)
    vote_step = make_vote_step(model, config, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 7)

    best_acc, best_vote, start_epoch = 0.0, 0.0, 0
    auto = getattr(args, "auto_resume", False) and os.path.exists(
        os.path.join(args.experiment_path, "ckpt-last.pth"))
    if getattr(args, "resume", False) or auto:
        state, start_epoch, best_acc = resume_checkpoint(args.experiment_path, state,
                                                         logger=logger_name)
    writer = ScalarWriter(getattr(args, "tfboard_path", None))
    try:
        for epoch in range(start_epoch, max_epoch + 1):
            loader.set_epoch(epoch)
            meters = AverageMeter(["loss", "acc"])
            t0 = time.time()
            step_metrics = []
            for batch in loader:
                # metrics stay on the device: one read at the epoch's end
                step_metrics.append(train_step(
                    state, torch.from_numpy(np.asarray(batch["points"], np.float32)),
                    torch.from_numpy(np.asarray(batch["label"])), generator=generator))
            if step_metrics:
                for loss, acc in torch.stack([torch.stack([m["loss"], m["acc"]])
                                              for m in step_metrics]).tolist():
                    meters.update([loss, acc])
            writer.add_scalar("Loss/Epoch/loss", meters.avg(0), epoch)
            writer.add_scalar("Metric/TrainACC", meters.avg(1), epoch)
            print_log(f"[Training] EPOCH: {epoch} EpochTime = "
                      f"{time.time() - t0:.3f} (s) "
                      f"Losses = ['{meters.avg(0):.4f}', '{meters.avg(1):.4f}']",
                      logger=logger_name)
            acc = evaluate(eval_step, val_batches(), total_bs)
            writer.add_scalar("Metric/ACC", acc, epoch)
            print_log(f"[Validation] EPOCH: {epoch}  acc = {acc:.4f} "
                      f"time = {time.time() - t0:.1f}s", logger=logger_name)
            better = acc > best_acc
            if better:
                best_acc = acc
                save_checkpoint(args.experiment_path, "ckpt-best", state, epoch, best_acc,
                                logger=logger_name)
            # the 91 band votes only on improving epochs (:254-262)
            if getattr(args, "vote", False) and (acc > 92.1 or (better and acc > 91)):
                vacc = vote_eval(vote_step, val_batches(), total_bs, generator)
                best_vote = max(best_vote, vacc)
                print_log(f"[Validation_vote] EPOCH: {epoch}  vote_acc = {vacc:.4f}",
                          logger=logger_name)
            save_checkpoint(args.experiment_path, "ckpt-last", state, epoch, best_acc,
                            logger=logger_name)
    finally:
        writer.close()
    return {"best_acc": best_acc, "best_vote": best_vote, "state": state}


def test_net(config, args, logger_name: str = "PointDAE", device=None) -> float:
    """The test protocol (runner_finetune.py:686-748): the accuracy of the
    ``--ckpts`` checkpoint, then under ``--vote`` ``vote_repeats`` (299)
    voting passes, keeping the best."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader
    from ..models import build_model_from_cfg

    dev = resolve_device(device)
    dcfg = config["dataset"]
    test_set = build_dataset_from_cfg(dcfg["test"]["_base_"], dcfg["test"]["others"],
                                      device=dev)
    total_bs = int(config.get("total_bs", 32))
    model = build_model_from_cfg(config["model"], device=dev, seed=0)
    _warm_start(model, args.ckpts, logger_name)

    def batches():
        return DataLoader(test_set, total_bs, shuffle=False, drop_last=False)

    acc = evaluate(make_eval_step(model, config, device=dev), batches(), total_bs)
    print_log(f"[TEST] acc = {acc:.4f}", logger=logger_name)
    if getattr(args, "vote", False):
        vote_step = make_vote_step(model, config, device=dev)
        generator = torch.Generator(device=dev).manual_seed(int(getattr(args, "seed", 0)))
        best = 0.0
        for it in range(int(getattr(args, "vote_repeats", 299))):
            v = vote_eval(vote_step, batches(), total_bs, generator)
            best = max(best, v)
            print_log(f"[TEST_VOTE] iter {it}: acc = {v:.4f} best = {best:.4f}",
                      logger=logger_name)
    return acc
