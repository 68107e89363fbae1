"""DAE pretraining: the step and the run (port of
``point_dae_tpu/engine/pretrain.py``; reference tools/runner_pretrain.py).

One step: augment and resample the raw clouds on the device, run the model
forward, backward, one AdamW update; the BatchNorm running statistics
move during the forward, as flax's mutable ``batch_stats`` do.

``run_pretrain`` is the epoch loop: the streaming loader or the device
cache, the loss-type schedule, the metrics pulled to the host every 50
steps and at an epoch's end, the SVM probe each ``val_freq`` epochs
(frozen ``model.encode`` features after an FPS subsample, then a
``LinearSVC``), ``ckpt-best`` and ``ckpt-last``, and the log lines that
result-scraping tools read. ``LinearSVC`` is the port's own: sklearn's
``LinearSVC(C=0.01)`` objective solved by Newton's method on the device.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.corruptions import (CloudCorruptDraws, augment_batch, corrupt_batch, masks_points,
                                sample_augment_draws, sample_corrupt_draws)
from ..models import build_model_from_cfg
from ..models.common import DropoutDAE, DropoutDraws
from ..models.transformer import ModelDraws
from ..ops.geometry import furthest_point_sample, gather_points, resample_batch
from ..parallel.mesh import (get_mesh, mean_over_ranks, replicate, row_drawer, sharded_eval,
                             train_loader)
from ..utils.config import propagate_corrupt_type
from ..utils.device import resolve_device
from ..utils.logger import ScalarWriter, print_log
from ..utils.meters import AverageMeter
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
    dropouts for a DGCNN DAE, the Gumbel noise (B, G, V) for
    ``Point_dVAE``; None draws them from the generator."""
    pipeline: PipelineDraws
    model: Optional[Union[ModelDraws, Sequence[DropoutDraws], torch.Tensor]] = None


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


def sample_step_draws(model: torch.nn.Module, aug_type: Sequence[str],
                      corrupt_type: Sequence[str], npoints: int, batch: int, n_raw: int,
                      generator: Optional[torch.Generator], device) -> StepDraws:
    """Every draw of one pretrain step for ``batch`` raw clouds of ``n_raw``
    rows, taken from ``generator`` in the order the step takes them when it
    draws them itself: the augmentations, the corruptions, the corrupted
    and the clean resample, then the model's own (``sample_draws``; a DAE's
    in-model dropouts on clouds of ``npoints``)."""
    augment = sample_augment_draws(aug_type, batch, generator, device)
    corrupt = sample_corrupt_draws(corrupt_type, batch, n_raw, generator, device)
    if masks_points(corrupt_type):
        corrupted = torch.rand((batch, npoints), generator=generator, device=device)
    else:
        corrupted = torch.randint(0, n_raw, (batch, npoints), generator=generator,
                                  device=device)
    clean = torch.randint(0, n_raw, (batch, npoints), generator=generator, device=device)
    sample = getattr(model, "sample_draws", None)
    if isinstance(model, DropoutDAE):
        own = sample(batch, generator, device, n=npoints)
    else:
        own = None if sample is None else sample(batch, generator, device)
    return StepDraws(PipelineDraws(corrupted, clean, corrupt, augment), own)


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


def gradual_weight_for(loss_type: str, epoch: int, max_epoch: int) -> float:
    """runner_pretrain.py:113-123."""
    if loss_type == "xyznormal_gradual":
        return float(epoch) / float(max_epoch)
    if loss_type == "xyznormal_warm":
        return min(float(epoch) / float(max_epoch) * 3.0, 1.0)
    return 0.0


def init_model(config, seed: int = 0, device=None) -> torch.nn.Module:
    """The configured model with weights drawn from ``seed``; an unset
    ``model.corrupt_type`` takes the train dataset's first, as a pretrain
    run's config load does (``utils/config.py:propagate_corrupt_type``)."""
    return build_model_from_cfg(propagate_corrupt_type(config)["model"], device=device,
                                seed=seed)


def bn_momentum_for(bcfg, epoch: int) -> float:
    """The ``bnmscheduler``'s torch-convention BatchNorm momentum of an
    epoch (misc.py:34-40): ``max(bn_momentum * bn_decay ** (epoch /
    decay_step), lowest_decay)``, lowest_decay 0.01 by default."""
    k = bcfg["kwargs"]
    return max(float(k["bn_momentum"]) * float(k["bn_decay"]) ** (epoch / float(k["decay_step"])),
               float(k.get("lowest_decay", 0.01)))


def batch_norms(model: torch.nn.Module) -> list:
    """The model's BatchNorm layers (``models/layers.py:BatchNorm``)."""
    from ..models.layers import BatchNorm

    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def make_train_step(model: torch.nn.Module, config, device=None) -> Callable:
    """Build the pretrain step. Signature:
    ``step(state, raw (B, Nraw, C), generator=None, gradual_weight=0.0,
    draws=None, labels=None, bn_momentum=None) -> {"loss_xyz",
    "loss_normal"}`` (device tensors; nothing waits for the card).
    ``draws`` (a ``StepDraws``) replaces every random draw of the step;
    otherwise they come from ``generator`` (``sample_step_draws``, through
    ``parallel/mesh.py:row_drawer``): under a process group the global
    batch's, of which ``raw``'s rows are kept, and the metrics are the
    global batch's. ``labels`` (B,) go to a model
    that ``is_supervised``, which needs them. ``bn_momentum`` (the
    ``bnmscheduler``'s, ``bn_momentum_for``): the BatchNorm layers move
    their running statistics with flax's fixed momentum 0.9 (torch's 0.1);
    the move is linear in the batch's statistics, so after the forward
    each is re-blended to the scheduled one, ``old + (new - old) * (m /
    0.1)``, as the JAX package does."""
    dev = resolve_device(device)
    d = config["dataset"]["train"]["others"]
    aug_type = tuple(d.get("aug_type", ("norm",)))
    corrupt_type = tuple(d.get("corrupt_type", ("clean",)))
    npoints = int(d.get("npoints", 1024))
    loss_type = config.get("loss_type", "xyz")
    normal_weight = float(config.get("normal_weight", 1.0))
    supervised = bool(getattr(model, "is_supervised", False))
    norms = batch_norms(model)
    step_draws = row_drawer(lambda b, n, g: sample_step_draws(
        model, aug_type, corrupt_type, npoints, b, n, g, dev))

    def step(state: TrainState, raw: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             gradual_weight: float = 0.0, draws: Optional[StepDraws] = None,
             labels: Optional[torch.Tensor] = None, bn_momentum: Optional[float] = None):
        if draws is None:
            draws = step_draws(raw.shape[0], raw.shape[1], generator)
        corrupted, clean = device_pipeline(raw, aug_type, corrupt_type, npoints,
                                           draws=draws.pipeline, generator=generator,
                                           device=dev)
        kw = {}
        if supervised:
            if labels is None:
                raise ValueError(f"{type(model).__name__} is supervised: the step needs labels")
            kw["labels"] = torch.as_tensor(labels).reshape(-1).to(dev)
        if bn_momentum is not None:
            old = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in norms]
        model.train()
        loss_xyz, loss_normal = model(corrupted, clean, draws=draws.model,
                                      generator=generator, **kw)
        if bn_momentum is not None:
            scale = bn_momentum / 0.1
            with torch.no_grad():
                for bn, (mean, var) in zip(norms, old):
                    bn.running_mean.copy_(mean + (bn.running_mean - mean) * scale)
                    bn.running_var.copy_(var + (bn.running_var - var) * scale)
        loss = compute_loss(loss_type, loss_xyz, loss_normal, normal_weight,
                            gradual_weight)
        state.zero_grad()
        loss.backward()
        state.apply_gradients()
        return mean_over_ranks({"loss_xyz": loss_xyz.detach(),
                                "loss_normal": loss_normal.detach()})

    return step


def make_feature_fn(model: torch.nn.Module, npoints: int = 1024, device=None) -> Callable:
    """``feats(pts (B, N, >= 3)) -> (B, F)``: the frozen features of the SVM
    probe, after an FPS subsample to ``npoints`` where the clouds are larger
    (runner_pretrain.py:310-318)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def feats(pts: torch.Tensor) -> torch.Tensor:
        pts = pts.to(dev)[..., :3].contiguous()
        if pts.shape[1] > npoints:
            pts = gather_points(pts, furthest_point_sample(pts, npoints))
        model.eval()
        return model.encode(pts)

    return feats


class LinearSVC:
    """sklearn's ``LinearSVC`` with its defaults (squared hinge, L2 penalty,
    one-vs-rest with one classifier for two classes, the intercept an extra
    feature of value 1 that is regularised too): for each class k, with y =
    +1 on the class and -1 elsewhere, w_k minimises ``0.5 |w|^2 + C sum_i
    max(0, 1 - y_i w.[x_i, 1])^2``. The objective is strictly convex, so
    its optimum is sklearn's answer whichever solver reaches it. Solved for
    all classes at once in float64 on ``device`` by Newton's method (the
    exact Hessian ``I + 2C X_A^T X_A`` over the active rows, one Cholesky
    solve a class) with a backtracking line search, until every class's
    gradient norm is below ``TOL`` of its first: far below sklearn's own
    stopping point (tol 1e-4), so the answer is the optimum's."""

    TOL = 1e-7
    MAX_ITER = 100

    def __init__(self, C: float = 0.01, device=None):
        self.C = float(C)
        self.device = resolve_device(device)

    def _x(self, X) -> torch.Tensor:
        X = torch.as_tensor(X).to(self.device, torch.float64)
        return torch.cat([X, torch.ones_like(X[:, :1])], 1)

    def fit(self, X, y) -> "LinearSVC":
        X = self._x(X)
        y = torch.as_tensor(np.asarray(y).reshape(-1), device=self.device)
        self.classes_ = torch.unique(y)
        if len(self.classes_) < 2:
            raise ValueError("LinearSVC needs at least two classes")
        pos = self.classes_[1:] if len(self.classes_) == 2 else self.classes_
        Y = torch.where(y[:, None] == pos[None, :], 1.0, -1.0).to(X.dtype)   # (n, K)
        C = self.C
        W = torch.zeros(Y.shape[1], X.shape[1], dtype=X.dtype, device=self.device)
        M = X @ W.T

        def objective(W, M):
            return 0.5 * (W * W).sum(1) + C * (1 - Y * M).clamp_min(0).square().sum(0)

        f = objective(W, M)
        eye = torch.eye(X.shape[1], dtype=X.dtype, device=self.device)
        g0 = None
        self.n_iter_ = 0
        for self.n_iter_ in range(1, self.MAX_ITER + 1):
            A = (Y * M < 1).to(X.dtype)
            G = W + 2 * C * ((A * (M - Y)).T @ X)
            gnorm = torch.linalg.vector_norm(G, dim=1)
            g0 = gnorm if g0 is None else g0
            if bool((gnorm <= self.TOL * g0).all()):
                break
            H = torch.stack([eye + 2 * C * (X.T @ (A[:, k, None] * X))
                             for k in range(Y.shape[1])])
            D = -torch.cholesky_solve(G[..., None], torch.linalg.cholesky(H))[..., 0]
            DM = X @ D.T
            slope = (G * D).sum(1)
            t = torch.ones_like(slope)
            for _ in range(40):
                Wt, Mt = W + t[:, None] * D, M + t * DM
                ft = objective(Wt, Mt)
                ok = ft <= f + 1e-4 * t * slope
                if bool(ok.all()):
                    break
                t = torch.where(ok, t, t / 2)
            else:
                break           # no decrease left at float64 precision
            W, M, f = Wt, Mt, ft
        self.coef_, self.intercept_ = W[:, :-1], W[:, -1]
        return self

    def decision_function(self, X) -> torch.Tensor:
        """(n,) for two classes (positive: the second), else (n, K)."""
        d = self._x(X)[:, :-1] @ self.coef_.T + self.intercept_
        return d[:, 0] if len(self.classes_) == 2 else d

    def predict(self, X) -> torch.Tensor:
        d = self.decision_function(X)
        if len(self.classes_) == 2:
            return self.classes_[(d > 0).long()]
        return self.classes_[d.argmax(1)]


def evaluate_svm(train_features, train_labels, test_features, test_labels,
                 c: float = 0.01, device=None) -> float:
    """The LinearSVC probe (runner_pretrain.py:44-48): fit on the train
    features, the accuracy (a fraction) on the test features."""
    clf = LinearSVC(C=c, device=device).fit(train_features, train_labels)
    pred = clf.predict(test_features).cpu().numpy()
    return float((pred == np.asarray(test_labels).reshape(-1)).mean())


def _svm_validate(feature_fn: Callable, train_set, test_set, device,
                  batch_size: int = 64) -> float:
    """Frozen features of the probe's train and test sets, then the
    LinearSVC (runner_pretrain.validate :290-349)."""
    from ..data.loader import DataLoader

    def extract(ds):
        feats, labels = [], []
        for batch in DataLoader(ds, batch_size, shuffle=False, drop_last=False):
            # under a process group each rank extracts its rows; every rank
            # gets all features and fits the same probe
            feats.append(sharded_eval(feature_fn, torch.from_numpy(
                np.asarray(batch["points"][..., :3], np.float32))))
            labels.append(batch["label"])
        return torch.cat(feats), np.concatenate(labels)

    tr_f, tr_l = extract(train_set)
    te_f, te_l = extract(test_set)
    return evaluate_svm(tr_f, tr_l, te_f, te_l, device=device)


def _teacher_state(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors under the frozen teacher's names: an encoder
    saved under ``MAE_encoder.`` is re-rooted, anything else prefixed."""
    return {"teacher." + (k[len("MAE_encoder."):] if k.startswith("MAE_encoder.") else k): v
            for k, v in state_dict.items()}


def _dvae_state(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A dVAE checkpoint's tensors under ``dvae_teacher.``: Point-BERT's
    ``dVAE.pth`` names (``encoder.``, ``dgcnn_1.``, ``codebook``, ...) with
    its 1x1 convolution weights flattened to (out, in), or a ``Point_dVAE``
    checkpoint's (``dvae.``)."""
    out = {}
    for k, v in state_dict.items():
        if v.dim() > 2 and all(d == 1 for d in v.shape[2:]):
            v = v.reshape(v.shape[:2])
        out["dvae_teacher." + (k[len("dvae."):] if k.startswith("dvae.") else k)] = v
    return out


def merge_dvae_teacher(model: torch.nn.Module, path: str,
                       logger: Optional[str] = None) -> list:
    """``model.dvae_config.ckpt``: the tokenizer of ``MaskSurf_v2_token_dis``
    from a Point-BERT ``dVAE.pth`` or a ``Point_dVAE`` checkpoint (the
    JAX package's ``engine/pretrain.py:433-475``). Raises ValueError when
    no parameter of ``dvae_teacher`` is named in the file: the reference
    loads it strictly, and a random tokenizer would waste the run. Returns
    the unmatched names."""
    from ..utils.checkpoint import load_params, merge_pretrained

    src = _dvae_state(load_params(path, path))
    own = {n for n, _ in model.named_parameters() if n.startswith("dvae_teacher.")}
    if not own & set(src):
        raise ValueError(f"dvae_config.ckpt {path!r} matched 0 of the dvae_teacher "
                         f"parameters - check dvae_config dims (num_tokens/encoder_dims/...) "
                         f"against the checkpoint")
    return merge_pretrained(model, src, logger=logger)


def run_pretrain(config, args, logger_name: str = "PointDAE",
                 device=None) -> Dict[str, Any]:
    """The pretraining run (runner_pretrain.run_net). ``args`` carries the
    CLI's fields (seed, experiment_path, tfboard_path, val_freq, resume,
    auto_resume, start_ckpts). Returns {"best_acc", "state"}. Under a
    process group each rank trains on ``total_bs / world`` rows of every
    global batch (``parallel/mesh.py``) and only rank 0 writes."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.device_cache import DTYPES, build_device_cache
    from ..utils.checkpoint import (load_params, merge_pretrained, resume_checkpoint,
                                    save_checkpoint)

    dev = resolve_device(device)
    seed = int(getattr(args, "seed", 0))
    dcfg = config["dataset"]

    def dataset(split):
        return build_dataset_from_cfg(dcfg[split]["_base_"], dcfg[split]["others"],
                                      device=dev) if split in dcfg else None

    train_set, val_set, extra_set = dataset("train"), dataset("val"), dataset("extra_train")
    if (val_set is None) != (extra_set is None):
        print_log("[WARNING] dataset config has only one of val/extra_train "
                  "- per-epoch SVM validation is DISABLED (no ckpt-best "
                  "will be written)", logger=logger_name)
    total_bs = int(config.get("total_bs", 32))
    mesh = get_mesh()
    loader = train_loader(train_set, total_bs, seed, mesh)
    steps_per_epoch = max(len(loader), 1)
    max_epoch = int(config.get("max_epoch", 300))
    loss_type = config.get("loss_type", "xyz")

    model = init_model(config, seed=seed, device=dev)
    supervised = bool(getattr(model, "is_supervised", False))
    device_cache = None
    others = dcfg["train"].get("others", {})
    if others.get("device_cache") and supervised:
        print_log("[DeviceCache] supervised pretrain needs labels: streaming loader kept",
                  logger=logger_name)
    elif others.get("device_cache"):
        device_cache = build_device_cache(
            train_set, dtype=DTYPES[str(others.get("device_cache_dtype", "float16"))],
            max_bytes=int(others.get("device_cache_max_bytes", 12 * 2 ** 30)),
            seed=seed, device=dev, logger_name=logger_name, mesh=mesh)
        steps_per_epoch = max(device_cache.steps_per_epoch(total_bs), 1)

    if getattr(args, "start_ckpts", None):          # runner_pretrain.py:74-75
        merge_pretrained(model, load_params(args.start_ckpts, args.start_ckpts),
                         logger=logger_name)
    # the frozen teacher's checkpoint, under any of the reference's spellings
    mcfg = config["model"]
    teacher_ckpt = mcfg.get("teacher_ckpt")
    for sub in ("teacher_config", "supervised_config", "pointmae_config"):
        if not teacher_ckpt:
            teacher_ckpt = (mcfg.get(sub) or {}).get("ckpt")
    if teacher_ckpt and hasattr(model, "teacher"):
        merge_pretrained(model, _teacher_state(load_params(teacher_ckpt, teacher_ckpt)),
                         logger=logger_name)
    dvae_ckpt = (mcfg.get("dvae_config") or {}).get("ckpt")
    if dvae_ckpt and hasattr(model, "dvae_teacher"):
        merge_dvae_teacher(model, dvae_ckpt, logger=logger_name)

    replicate(mesh, model)
    state = TrainState.create(model, config, steps_per_epoch, config.get("grad_norm_clip"))
    start_epoch, best_acc = 0, 0.0
    auto = getattr(args, "auto_resume", False) and os.path.exists(
        os.path.join(args.experiment_path, "ckpt-last.pth"))
    if getattr(args, "resume", False) or auto:
        state, start_epoch, best_acc = resume_checkpoint(args.experiment_path, state,
                                                         logger=logger_name)
    spd = int(config.get("steps_per_dispatch", 1))
    if spd > 1:
        print_log(f"steps_per_dispatch {spd} fuses steps into one dispatch in the JAX "
                  f"package; the port runs the same {steps_per_epoch} optimizer steps an "
                  f"epoch, one dispatch each", logger=logger_name)

    train_step = make_train_step(model, config, device=dev)
    val_np = int(dcfg["val"].get("others", {}).get("npoints", 1024)) if "val" in dcfg else 1024
    feature_fn = make_feature_fn(model, npoints=val_np, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    val_freq = int(getattr(args, "val_freq", 1))
    writer = ScalarWriter(getattr(args, "tfboard_path", None))
    n_step = start_epoch * steps_per_epoch
    bcfg = config.get("bnmscheduler")
    try:
        for epoch in range(start_epoch, max_epoch + 1):
            loader.set_epoch(epoch)
            gw = gradual_weight_for(loss_type, epoch, max_epoch)
            bn_m = None if bcfg is None else bn_momentum_for(bcfg, epoch)
            losses = AverageMeter(["xyz", "normal"])
            t_epoch = time.time()
            if device_cache is not None:
                device_cache.set_epoch(epoch)
                batches = ((device_cache.batch(i, total_bs), None)
                           for i in range(steps_per_epoch))
            else:
                batches = ((torch.from_numpy(b["points"]), b["label"] if supervised else None)
                           for b in loader)
            for raw, labels in batches:
                metrics = train_step(state, raw, generator=generator, gradual_weight=gw,
                                     labels=labels, bn_momentum=bn_m)
                n_step += 1
                # pull metrics to the host sparsely: a read waits for the card
                if n_step % 50 == 0 or n_step % steps_per_epoch == 0:
                    lx, ln = float(metrics["loss_xyz"]), float(metrics["loss_normal"])
                    losses.update([lx * 1000, ln * 1000])
                    writer.add_scalar("Loss/Batch/Loss_xyz", lx, n_step)
                    writer.add_scalar("Loss/Batch/LR", state.schedule(n_step), n_step)
            print_log(
                f"[Training] EPOCH: {epoch} EpochTime = {time.time() - t_epoch:.3f} (s) "
                f"Losses = {[f'{v:.4f}' for v in losses.avg()]}", logger=logger_name)
            if val_set is not None and extra_set is not None and epoch % val_freq == 0:
                acc = _svm_validate(feature_fn, extra_set, val_set, dev)
                writer.add_scalar("Metric/ACC", acc, epoch)
                print_log(f"[Validation] EPOCH: {epoch}  acc = {acc:.4f}", logger=logger_name)
                if acc > best_acc:
                    best_acc = acc
                    save_checkpoint(args.experiment_path, "ckpt-best", state, epoch,
                                    best_acc, logger=logger_name)
            save_checkpoint(args.experiment_path, "ckpt-last", state, epoch, best_acc,
                            logger=logger_name)
    finally:
        writer.close()
    return {"best_acc": best_acc, "state": state}
