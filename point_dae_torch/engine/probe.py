"""Frozen-feature probes: the SVM grid search and the task-affinity linear
head (port of ``point_dae_tpu/engine/probe.py``; reference
tools/runner_finetune.py:902-1289).

``extract_features`` subsamples each cloud to ``npoints`` by FPS and runs
the feature extractor in eval mode, 64 clouds a batch; the last short
batch runs as it is (eval-mode BatchNorm makes the JAX package's padding
irrelevant). ``svm_grid_search`` fits ``SVC`` for C = 10^i, i in -3..2,
and logs each accuracy and the best; ``task_affinity`` trains a linear
head on the frozen features (AdamW over a cosine decay, full batch, one
update an epoch, 300 epochs, zero initialisation) and logs the test
cross-entropy. The log lines are the JAX package's, letter for letter:
``parse_acc_affinity.py`` scrapes them.

``SVC`` is the port's own: the model of ``sklearn.svm.SVC(C,
kernel="linear")`` (libsvm's C-SVC: hinge loss, an unregularised bias,
one-vs-one over every class pair, prediction by vote with ties to the
lowest class index), solved for all pairs at once in float64 on the
device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.geometry import furthest_point_sample, gather_points
from ..parallel.mesh import sharded_eval
from ..utils.device import resolve_device
from ..utils.logger import print_log

SVM_EXPONENTS = range(-3, 3)


class SVC:
    """Linear-kernel C-SVC, one-vs-one, as libsvm solves it. For each class
    pair (a, b), a < b in sorted order, with y = +1 on a's points and -1 on
    b's, the dual ``min 0.5 a^T Q a - e^T a`` over 0 <= a <= C, y^T a = 0
    (Q_ij = y_i y_j x_i.x_j) is solved by libsvm's SMO: the working pair is
    the maximal violating i and the second-order choice of j, the two
    variables move to their clipped optimum, and a pair stops when the
    violation m(a) - M(a) is below ``tol`` (libsvm's stopping rule, tol
    1e-3 as sklearn's default). Every pair runs at once, in float64, on
    ``device``, from one Gram matrix of the training features; a pair
    that has stopped no longer moves. The bias is libsvm's: -rho, rho the
    mean of y_i G_i over the free vectors, else the midpoint of the
    feasible interval. The decision of a pair is w.x - rho with w =
    sum_i a_i y_i x_i; a positive one votes for a. ``n_iter_``: the
    iterations run until the last pair stopped, in chunks of
    ``CHECK_EVERY``."""

    TAU = 1e-12
    CHECK_EVERY = 32
    MAX_ITER = 200000

    def __init__(self, C: float = 1.0, tol: float = 1e-3, device=None):
        self.C = float(C)
        self.tol = float(tol)
        self.device = resolve_device(device)

    def _pairs(self, y: torch.Tensor):
        """(a, b) of every class pair, and the pair problems' rows: global
        indices (P, L) with -1 padding, labels (P, L) +1 / -1 / 0."""
        members = [torch.nonzero(y == k)[:, 0] for k in range(len(self.classes_))]
        pairs = [(a, b) for a in range(len(members)) for b in range(a + 1, len(members))]
        L = max(len(members[a]) + len(members[b]) for a, b in pairs)
        idx = torch.full((len(pairs), L), -1, dtype=torch.long, device=self.device)
        lab = torch.zeros((len(pairs), L), dtype=torch.float64, device=self.device)
        for p, (a, b) in enumerate(pairs):
            na, nb = len(members[a]), len(members[b])
            idx[p, :na + nb] = torch.cat([members[a], members[b]])
            lab[p, :na] = 1.0
            lab[p, na:na + nb] = -1.0
        return pairs, idx, lab

    def fit(self, X, y) -> "SVC":
        X = torch.as_tensor(X).to(self.device, torch.float64)
        y = torch.as_tensor(np.asarray(y).reshape(-1), device=self.device)
        self.classes_, yi = torch.unique(y, return_inverse=True)
        if len(self.classes_) < 2:
            raise ValueError("SVC needs at least two classes")
        self.pairs_, idx, lab = self._pairs(yi)
        valid = idx >= 0
        gidx = idx.clamp_min(0)
        K = X @ X.T
        kd = K.diagonal()[gidx]                                     # (P, L)
        f64 = dict(dtype=torch.float64, device=self.device)
        C, inf = self.C, torch.tensor(float("inf"), **f64)
        c_t, zero = torch.tensor(C, **f64), torch.zeros((), **f64)     # exact bounds
        alpha = torch.zeros_like(lab)
        G = torch.where(valid, -1.0, 0.0).to(torch.float64)      # Q a - e at a = 0
        stopped = torch.zeros(len(self.pairs_), dtype=torch.bool, device=self.device)
        rows = torch.arange(len(self.pairs_), device=self.device)
        pos, neg = lab > 0, lab < 0

        def smo_step():
            """One SMO iteration of every pair, in place on alpha, G and
            stopped (no host sync, so that CUDA can replay it as a graph)."""
            up = valid & ((pos & (alpha < C)) | (neg & (alpha > 0)))
            low = valid & ((pos & (alpha > 0)) | (neg & (alpha < C)))
            v = -lab * G
            gmax, i = torch.where(up, v, -inf).max(1)
            gmin = torch.where(low, v, inf).min(1).values
            Ki = K[gidx[rows, i][:, None], gidx]                        # (P, L)
            diff = gmax[:, None] - v
            cand = low & (diff > 0)
            quad = kd[rows, i][:, None] + kd - 2.0 * Ki
            quad = torch.where(quad > 0, quad, self.TAU)
            j = torch.where(cand, -(diff * diff) / quad, inf).argmin(1)
            stopped.logical_or_((gmax - gmin < self.tol) | ~cand.any(1))
            Kj = K[gidx[rows, j][:, None], gidx]
            yi_, yj_ = lab[rows, i], lab[rows, j]
            ai, aj = alpha[rows, i], alpha[rows, j]
            cap_i = torch.where(yi_ > 0, C - ai, ai)
            cap_j = torch.where(yj_ > 0, aj, C - aj)
            t = torch.minimum(diff[rows, j] / quad[rows, j], torch.minimum(cap_i, cap_j))
            t = torch.where(stopped, zero, t)
            ai_new = torch.where(t >= cap_i, torch.where(yi_ > 0, c_t, zero), ai + yi_ * t)
            aj_new = torch.where(t >= cap_j, torch.where(yj_ > 0, zero, c_t), aj - yj_ * t)
            alpha.index_put_((rows, i), torch.where(stopped, ai, ai_new))
            alpha.index_put_((rows, j), torch.where(stopped, aj, aj_new))
            G.add_(lab * t[:, None] * (Ki - Kj))

        def chunk():
            for _ in range(self.CHECK_EVERY):
                smo_step()

        run, self.n_iter_ = chunk, 0
        while self.n_iter_ < self.MAX_ITER:
            run()
            self.n_iter_ += self.CHECK_EVERY
            if bool(stopped.all()):
                break
            if run is chunk and self.device.type == "cuda":
                # the chunk's launches captured once and replayed
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    chunk()
                run = graph.replay
        self.converged_ = bool(stopped.all())
        self.rho_ = self._rho(alpha, G, lab, valid)
        coef = torch.zeros((len(self.pairs_), X.shape[0]), dtype=torch.float64,
                           device=self.device)
        coef.scatter_add_(1, gidx, torch.where(valid, alpha * lab, 0.0))
        self.coef_ = coef @ X                                       # (P, F)
        return self

    def _rho(self, alpha, G, lab, valid) -> torch.Tensor:
        """libsvm's ``calculate_rho`` for each pair."""
        yG = lab * G
        at_c, at_0 = alpha >= self.C, alpha <= 0
        free = valid & ~at_c & ~at_0
        to_ub = valid & ((at_c & (lab < 0)) | (at_0 & (lab > 0)))
        to_lb = valid & ((at_c & (lab > 0)) | (at_0 & (lab < 0)))
        inf = float("inf")
        ub = torch.where(to_ub, yG, inf).min(1).values
        lb = torch.where(to_lb, yG, -inf).max(1).values
        nfree = free.sum(1)
        mean = torch.where(free, yG, 0.0).sum(1) / nfree.clamp_min(1)
        return torch.where(nfree > 0, mean, (ub + lb) / 2)

    def decision_function(self, X) -> torch.Tensor:
        """(n, P): each pair's decision, positive for its first class."""
        X = torch.as_tensor(X).to(self.device, torch.float64)
        return X @ self.coef_.T - self.rho_

    def predict(self, X) -> torch.Tensor:
        d = self.decision_function(X)
        n_cls = len(self.classes_)
        votes = torch.zeros((d.shape[0], n_cls), dtype=torch.long, device=self.device)
        a = torch.tensor([p[0] for p in self.pairs_], device=self.device)
        b = torch.tensor([p[1] for p in self.pairs_], device=self.device)
        winner = torch.where(d > 0, a, b)                           # (n, P)
        votes.scatter_add_(1, winner, torch.ones_like(winner))
        return self.classes_[votes.argmax(1)]

    def score(self, X, y) -> float:
        pred = self.predict(X).cpu().numpy()
        return float((pred == np.asarray(y).reshape(-1)).mean())


def svm_grid_search(train_f, train_l, test_f, test_l, logger=None, device=None) -> float:
    """SVC(C=10^i, linear) for i in -3..2, each test accuracy logged, the
    best returned (percent)."""
    best = 0.0
    for i in SVM_EXPONENTS:
        acc = SVC(C=10.0 ** i, device=device).fit(train_f, train_l).score(test_f, test_l) * 100.0
        print_log(f"[SVM] C=10^{i}: acc = {acc:.4f}", logger=logger)
        best = max(best, acc)
    print_log(f"[SVM] best acc = {best:.4f}", logger=logger)
    return best


def extract_features(model: torch.nn.Module, dataset, npoints: int, batch_size: int = 64,
                     device=None) -> Tuple[torch.Tensor, np.ndarray]:
    """FPS to ``npoints``, then the extractor in eval mode: (features (n, F)
    on the device, labels (n,) numpy). Under a process group every rank
    gets every feature, so each fits the same SVC or affinity head."""
    from ..data.loader import DataLoader

    dev = resolve_device(device)
    model.eval()
    feats, labels = [], []

    def features(pts):
        pts = gather_points(pts, furthest_point_sample(pts[..., :3].contiguous(), npoints))
        return model(pts).float()

    with torch.no_grad():
        for batch in DataLoader(dataset, batch_size, shuffle=False, drop_last=False):
            pts = torch.from_numpy(np.asarray(batch["points"], np.float32)).to(dev)
            # under a process group each rank extracts its rows, all get all
            feats.append(sharded_eval(features, pts))
            labels.append(np.asarray(batch["label"]).reshape(-1))
    return torch.cat(feats), np.concatenate(labels)


def fit_linear_head(train_f: torch.Tensor, train_l, test_f: torch.Tensor, test_l,
                    epochs: int = 300, lr: float = 1e-3, weight_decay: float = 0.05
                    ) -> Tuple[float, float]:
    """The task-affinity head: logits x W + b from zeros, full-batch AdamW
    (decay lr * weight_decay on W and b, as ``optax.adamw`` masks nothing)
    over ``optax.cosine_decay_schedule(lr, epochs)`` read at the step count
    before the update, one update an epoch. Returns (test cross-entropy,
    test accuracy in percent)."""
    dev = train_f.device
    ys = torch.as_tensor(np.asarray(train_l).reshape(-1), device=dev).long()
    yt = torch.as_tensor(np.asarray(test_l).reshape(-1), device=dev).long()
    num_classes = int(ys.max()) + 1
    w = torch.zeros((train_f.shape[1], num_classes), device=dev, requires_grad=True)
    b = torch.zeros((num_classes,), device=dev, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    for count in range(epochs):
        for group in opt.param_groups:
            group["lr"] = lr * 0.5 * (1.0 + math.cos(math.pi * min(count, epochs) / epochs))
        loss = F.cross_entropy(train_f @ w + b, ys)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        logits = test_f @ w + b
        ce = float(F.cross_entropy(logits, yt))
        acc = float((logits.argmax(-1) == yt).float().mean()) * 100
    return ce, acc


def _probe_features(config, args, logger_name: str, dev):
    """The configured extractor (seed 0) with the ``--ckpts`` merge of its
    parameters and BatchNorm statistics by name, and its features of the
    train and test sets."""
    from ..data.datasets import build_dataset_from_cfg
    from ..models import build_model_from_cfg
    from ..utils.checkpoint import load_params, merge_pretrained

    dcfg = config["dataset"]
    train_set = build_dataset_from_cfg(dcfg["train"]["_base_"], dcfg["train"]["others"],
                                       device=dev)
    test_set = build_dataset_from_cfg(dcfg["test"]["_base_"], dcfg["test"]["others"],
                                      device=dev)
    npoints = int(config.get("npoints", 1024))
    model = build_model_from_cfg(config["model"], device=dev, seed=0)
    if getattr(args, "ckpts", None):
        merge_pretrained(model, load_params(args.ckpts, args.ckpts), logger=logger_name)
    return (extract_features(model, train_set, npoints, device=dev)
            + extract_features(model, test_set, npoints, device=dev))


def svm_classification(config, args, logger_name: str = "PointDAE", device=None) -> float:
    """--svm_classification: the grid search's best test accuracy (percent)."""
    dev = resolve_device(device)
    tr_f, tr_l, te_f, te_l = _probe_features(config, args, logger_name, dev)
    return svm_grid_search(tr_f, tr_l, te_f, te_l, logger=logger_name, device=dev)


def task_affinity(config, args, logger_name: str = "PointDAE", device=None,
                  epochs: int = 300, lr: float = 1e-3) -> float:
    """--task_affinity: the linear head's test cross-entropy, the affinity
    score."""
    dev = resolve_device(device)
    tr_f, tr_l, te_f, te_l = _probe_features(config, args, logger_name, dev)
    ce, acc = fit_linear_head(tr_f, tr_l, te_f, te_l, epochs=epochs, lr=lr)
    print_log(f"[TaskAffinity] test CE = {ce:.4f} acc = {acc:.4f}", logger=logger_name)
    # the reference's log format, which parse_acc_affinity.py --taskaffinity
    # reads (the value after '= ', the CE)
    print_log(f"[Validation] Acc: {acc / 100.0:.4f}  loss = {ce:.4f}", logger=logger_name)
    return ce
