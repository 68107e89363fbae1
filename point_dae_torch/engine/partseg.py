"""Part segmentation: the train and eval steps, the category-restricted
mIoU and the runs (port of ``point_dae_tpu/engine/partseg.py``; reference
segmentation/main.py).

A train step scales and shifts each cloud (``scale_shift``), runs the model
in train mode, takes the NLL over the per-point log-probs, clips the
gradients by their global norm when the state says so and makes one AdamW
update (``engine/train_state.py``); the BatchNorm running statistics move
during the forward. Random draws are inputs: a step takes a ``SegDraws`` or
draws one from the given ``torch.Generator``. ``evaluate_partseg``
restricts each shape's argmax to its category's parts and reports the
instance and class mIoU. ``run_partseg`` trains on ShapeNetPart and keeps
the best-mIoU weights in ``best_model.pth``; ``test_partseg`` evaluates a
checkpoint once.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..models.partseg import N_CATEGORIES, SegDraws, seg_nll_loss
from ..utils.device import resolve_device
from ..utils.logger import print_log
from ..utils.meters import AverageMeter
from .finetune import _warm_start, pad_to_batch
from .train_state import TrainState

SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23]}


def scale_shift(pts: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """random_scale_point_cloud + shift_point_cloud with their draws: an
    isotropic scale (B, 1, 1) and a shift (B, 1, 3), ``pts * s + t``."""
    return pts * scale + shift


def make_seg_train_step(model: torch.nn.Module, device=None) -> Callable:
    """Build the train step. Signature: ``step(state, pts (B, N, C),
    cls_onehot (B, 16), seg (B, N), generator=None, draws=None) -> {"loss",
    "acc"}`` (device tensors, acc a fraction). The optimizer and the clip
    live in ``state``
    (``TrainState.create(model, config, steps, config["grad_norm_clip"])``)."""
    dev = resolve_device(device)

    def step(state: TrainState, pts: torch.Tensor, cls_onehot: torch.Tensor,
             seg: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[SegDraws] = None):
        pts = pts.to(dev)[..., :3].float()
        cls_onehot = cls_onehot.to(dev).float()
        seg = seg.to(dev).long()
        if draws is None:
            draws = SegDraws.sample(model, pts.shape[0], pts.shape[1], generator, dev)
        pts = scale_shift(pts, draws.scale, draws.shift)
        model.train()
        logp = model(pts, cls_onehot, draws=draws)
        loss = seg_nll_loss(logp, seg)
        acc = (logp.argmax(-1) == seg).float().mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "acc": acc.detach()}

    return step


def make_seg_eval_step(model: torch.nn.Module, device=None) -> Callable:
    """``step(pts (B, N, C), cls_onehot (B, 16)) -> log-probs (B, N, parts)``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(pts: torch.Tensor, cls_onehot: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(pts.to(dev)[..., :3].float(), cls_onehot.to(dev).float())

    return step


def category_restricted_argmax(logp: np.ndarray, cat_names: Sequence[str]) -> np.ndarray:
    """Per-shape argmax restricted to the shape's category parts."""
    out = np.zeros(logp.shape[:2], np.int32)
    for b, name in enumerate(cat_names):
        parts = SEG_CLASSES[name]
        out[b] = np.asarray(parts)[np.argmax(logp[b][:, parts], axis=-1)]
    return out


def compute_miou(preds, targets, cat_names) -> Dict[str, float]:
    """Per-part IoU (1 where a part is in neither) -> per-shape mean ->
    class mIoU (mean over categories) and instance mIoU (over shapes)."""
    shape_ious = {c: [] for c in SEG_CLASSES}
    for pred, gt, name in zip(preds, targets, cat_names):
        ious = []
        for p in SEG_CLASSES[name]:
            pi, gi = pred == p, gt == p
            union = np.logical_or(pi, gi).sum()
            ious.append(1.0 if union == 0 else np.logical_and(pi, gi).sum() / union)
        shape_ious[name].append(float(np.mean(ious)))
    all_ious = [v for vals in shape_ious.values() for v in vals]
    cls_ious = {c: float(np.mean(v)) for c, v in shape_ious.items() if v}
    return {
        "instance_miou": float(np.mean(all_ious)) if all_ious else 0.0,
        "class_miou": float(np.mean(list(cls_ious.values()))) if cls_ious else 0.0,
        "per_class": cls_ious,
    }


def evaluate_partseg(eval_step: Callable, batches: Iterable[dict], batch_size: int,
                     cat_names: Sequence[str]) -> Dict[str, float]:
    """Category-restricted mIoU over ``batches`` ({"points" (b, N, C),
    "label" (b,) category index, "seg" (b, N)} of numpy arrays), a short
    tail batch zero-padded to ``batch_size``; ``cat_names`` maps a category
    index to its name (``sorted(SEG_CLASSES)``)."""
    preds, gts, names = [], [], []
    eye = np.eye(N_CATEGORIES, dtype=np.float32)
    for batch in batches:
        pts = pad_to_batch(np.asarray(batch["points"][..., :3], np.float32), batch_size)
        labels = np.asarray(batch["label"]).reshape(-1)
        n = len(labels)
        onehot = eye[np.concatenate([labels, np.zeros(batch_size - n, np.int64)])]
        logp = eval_step(torch.from_numpy(pts), torch.from_numpy(onehot))[:n]
        bnames = [cat_names[int(l)] for l in labels]
        preds.append(category_restricted_argmax(logp.float().cpu().numpy(), bnames))
        gts.append(np.asarray(batch["seg"]))
        names.extend(bnames)
    return compute_miou(np.concatenate(preds), np.concatenate(gts), names)


def _test_batches(config, dev):
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader

    dcfg = config["dataset"]
    split = dcfg.get("test", dcfg["train"])
    test_set = build_dataset_from_cfg(split["_base_"], split["others"], device=dev)
    total_bs = int(config.get("total_bs", 16))
    return lambda: DataLoader(test_set, total_bs, shuffle=False, drop_last=False)


def test_partseg(config, args, logger_name: str = "PointDAE", device=None):
    """``--test`` on a ShapeNetPart config: the category-restricted mIoU of
    the ``--ckpts`` checkpoint, once (the reference has no test mode)."""
    from ..models import build_model_from_cfg

    if not getattr(args, "ckpts", None):
        raise ValueError("--test on a partseg config requires --ckpts")
    dev = resolve_device(device)
    batches = _test_batches(config, dev)
    model = build_model_from_cfg(config["model"], device=dev, seed=0)
    _warm_start(model, args.ckpts, logger_name)
    m = evaluate_partseg(make_seg_eval_step(model, device=dev), batches(),
                         int(config.get("total_bs", 16)), sorted(SEG_CLASSES))
    print_log(f"[TEST] test inctance avg mIOU = {m['instance_miou']:.5f} "
              f"class avg mIOU = {m['class_miou']:.5f}", logger=logger_name)
    return m


def run_partseg(config, args, logger_name: str = "PointDAE", device=None):
    """The ShapeNetPart run (segmentation/main.py:181-323). Returns
    {"best_instance_miou", "best_class_miou"}."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader
    from ..models import build_model_from_cfg
    from ..utils.checkpoint import save_checkpoint

    dev = resolve_device(device)
    seed = int(getattr(args, "seed", 0))
    dcfg = config["dataset"]
    train_set = build_dataset_from_cfg(dcfg["train"]["_base_"], dcfg["train"]["others"],
                                       device=dev)
    test_batches = _test_batches(config, dev)
    cat_names = sorted(SEG_CLASSES)
    total_bs = int(config.get("total_bs", 16))
    loader = DataLoader(train_set, total_bs, shuffle=True, seed=seed)
    model = build_model_from_cfg(config["model"], device=dev, seed=0)
    if getattr(args, "ckpts", None):
        _warm_start(model, args.ckpts, logger_name)
    state = TrainState.create(model, config, max(len(loader), 1),
                              config.get("grad_norm_clip"))
    train_step = make_seg_train_step(model, device=dev)
    eval_step = make_seg_eval_step(model, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    eye = np.eye(N_CATEGORIES, dtype=np.float32)
    best_inst = best_cls = 0.0
    for epoch in range(int(config.get("max_epoch", 300)) + 1):
        loader.set_epoch(epoch)
        meters = AverageMeter(["loss", "acc"])
        t0 = time.time()
        step_metrics = []
        for batch in loader:
            step_metrics.append(train_step(
                state, torch.from_numpy(np.asarray(batch["points"][..., :3], np.float32)),
                torch.from_numpy(eye[np.asarray(batch["label"])]),
                torch.from_numpy(np.asarray(batch["seg"])), generator=generator))
        if step_metrics:
            for loss, acc in torch.stack([torch.stack([m["loss"], m["acc"]])
                                          for m in step_metrics]).tolist():
                meters.update([loss, acc])
        print_log(f"Epoch {epoch} train loss = {meters.avg(0):.5f} "
                  f"train acc = {meters.avg(1):.5f}", logger=logger_name)
        m = evaluate_partseg(eval_step, test_batches(), total_bs, cat_names)
        improved = m["instance_miou"] > best_inst
        best_inst = max(best_inst, m["instance_miou"])
        best_cls = max(best_cls, m["class_miou"])
        print_log(f"Epoch {epoch} test inctance avg mIOU = {m['instance_miou']:.5f} "
                  f"class avg mIOU = {m['class_miou']:.5f} "
                  f"time = {time.time() - t0:.1f}s", logger=logger_name)
        print_log(f"Best inctance avg mIOU is: {best_inst:.5f}", logger=logger_name)
        print_log(f"Best class avg mIOU is: {best_cls:.5f}", logger=logger_name)
        # best_model holds the best-mIoU weights (segmentation/main.py saves
        # only on improvement)
        if improved:
            save_checkpoint(args.experiment_path, "best_model", state, epoch, best_inst,
                            logger=logger_name)
    return {"best_instance_miou": best_inst, "best_class_miou": best_cls}
