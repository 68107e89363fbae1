"""The frozen-feature probes of the port on the CPU: the feature extractors
``DGCNN_feat``, ``DGCNN_Linear`` and the no-class-token transformer pair
against the JAX package (the port's weights carried across through
``to_flax``, BatchNorm statistics set away from (0, 1)); the port's ``SVC``
against ``sklearn.svm.SVC(kernel="linear")`` on seeded blobs for each C of
the grid; the task-affinity head against the JAX package's on the same
features; both CLI modes end to end on a Synthetic config written to
disk, with a checkpoint merged by ``--ckpts``, and their log lines."""
import copy
import logging
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from point_dae_tpu.engine import probe as jprobe
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch import cli
from point_dae_torch.engine import probe
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B = 4
_NCT = {"trans_dim": 32, "depth": 2, "drop_path_rate": 0.1, "cls_dim": 5, "num_heads": 2,
        "group_size": 8, "num_group": 16, "encoder_dims": 32}
# (model config, points a cloud)
EXTRACTORS = {"DGCNN_feat": ({"NAME": "DGCNN_feat", "cls_dim": 40}, 64),
              "DGCNN_Linear": ({"NAME": "DGCNN_Linear", "cls_dim": 7}, 64),
              "PointTransformerNoClassToken": (dict(_NCT, NAME="PointTransformerNoClassToken"),
                                               128),
              "PointTransformerNoClassTokenSVMFeature": (
                  dict(_NCT, NAME="PointTransformerNoClassTokenSVMFeature"), 128)}


def _port(name):
    """The port's model (seed 0) with its BatchNorm statistics moved away
    from (0, 1), and its weights as a flax tree."""
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(EXTRACTORS[name][0])), device="cpu")
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif n.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    return model, to_flax(model.state_dict())


@pytest.mark.parametrize("name", sorted(EXTRACTORS))
def test_extractor_matches_jax_in_eval(name):
    """Eval mode (the probes' mode): features or logits within 1e-4
    relative; the tree has the JAX model's paths and shapes and carries
    back."""
    cfg, n = EXTRACTORS[name]
    model, (params, stats) = _port(name)
    pts = np.random.default_rng(5).normal(size=(B, n, 3)).astype(np.float32)
    jmodel = j_build(JConfigDict(copy.deepcopy(cfg)))
    want = jax.jit(lambda p: jmodel.apply({"params": params, "batch_stats": stats}, p,
                                          train=False))(pts)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    shapes = jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32), jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)}, pts, train=False)))
    flat = lambda t: {k: np.shape(v) for k, v in _flatten(t).items()}  # noqa: E731
    assert flat(params) == flat(shapes["params"]) and flat(stats) == flat(shapes["batch_stats"])
    sd = model.state_dict()
    back = from_flax(params, stats)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_no_class_token_train_logits_match_jax(monkeypatch):
    """Train mode with the head's dropout and the blocks' keep masks fed to
    both packages: logits within 1e-4 relative."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from point_dae_tpu.models import layers as jlayers

    name = "PointTransformerNoClassToken"
    cfg, n = EXTRACTORS[name]
    model, (params, stats) = _port(name)
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(B, n, 3)).astype(np.float32)
    drop = {"dp0": rng.uniform(size=(B, 256)) >= 0.5, "dp1": rng.uniform(size=(B, 256)) >= 0.5}
    dp = np.ones((2, 2, B), bool)
    dp[1, 0, 2] = dp[1, 1, 0] = False
    monkeypatch.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                        if det or max(dpr) == 0.0 else jnp.asarray(dp))

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            return jnp.where(jnp.asarray(drop[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    jmodel = j_build(JConfigDict(copy.deepcopy(cfg)))
    with fnn.intercept_methods(intercept):
        want, _ = jax.jit(lambda p: jmodel.apply(
            {"params": params, "batch_stats": stats}, p, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0), "droppath": jax.random.key(1)}))(pts)
    got = model.train()(torch.from_numpy(pts), draws=ClsDraws(
        [torch.from_numpy(drop["dp0"]), torch.from_numpy(drop["dp1"])], torch.from_numpy(dp)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ the SVC

def _blobs():
    """240 train and 160 test rows of 6 overlapping Gaussian classes in 16
    dimensions (the accuracy moves with C)."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-10, 10, size=(6, 16))
    y = rng.integers(0, 6, size=400)
    x = centers[y] + rng.normal(0, 6.0, size=(400, 16))
    return x[:240], y[:240], x[240:], y[240:]


@pytest.mark.parametrize("exp", list(probe.SVM_EXPONENTS))
def test_svc_matches_sklearn(exp):
    """Predictions equal to sklearn's on at least 98% of the test rows."""
    from sklearn import svm

    xtr, ytr, xte, yte = _blobs()
    C = 10.0 ** exp
    want = svm.SVC(C=C, kernel="linear").fit(xtr, ytr).predict(xte)
    clf = probe.SVC(C=C, device="cpu").fit(xtr, ytr)
    got = clf.predict(xte).numpy()
    assert clf.converged_
    assert (got == want).mean() >= 0.98


def test_svm_grid_search_best_within_a_point_of_sklearn():
    """The grid's best accuracy within 1 point of sklearn's, the log lines
    in the JAX package's format."""
    from sklearn import svm

    xtr, ytr, xte, yte = _blobs()
    sk = max(svm.SVC(C=10.0 ** i, kernel="linear").fit(xtr, ytr).score(xte, yte) * 100
             for i in probe.SVM_EXPONENTS)
    lines = _Lines("t_svm_grid")
    best = probe.svm_grid_search(torch.from_numpy(xtr), ytr, torch.from_numpy(xte), yte,
                                 logger="t_svm_grid", device="cpu")
    lines.close()
    assert abs(best - sk) <= 1.0
    assert [re.match(r"^\[SVM\] C=10\^(-?\d): acc = \d+\.\d{4}$", ln).group(1)
            for ln in lines.lines[:-1]] == [str(i) for i in probe.SVM_EXPONENTS]
    assert lines.lines[-1] == f"[SVM] best acc = {best:.4f}"


# ------------------------------------------------------- task affinity, CLI

SYN = {"NAME": "Synthetic", "N_POINTS": 128, "num_classes": 5, "with_normal": True}


def _cfg(model, train=16, test=8):
    split = lambda sub, n, seed: {"_base_": dict(SYN), "others": {  # noqa: E731
        "subset": sub, "npoints": 64, "size": n, "seed": seed, "aug_type": ["clean"]}}
    return {"optimizer": {"type": "AdamW", "part": "all",
                          "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
            "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300}},
            "dataset": {"train": split("train", train, 0), "test": split("test", test, 1)},
            "model": model, "npoints": 64, "total_bs": 64}


class _Lines(logging.Handler):
    def __init__(self, name):
        super().__init__()
        self.lines, self.name_ = [], name
        logging.getLogger(name).addHandler(self)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def close(self):
        logging.getLogger(self.name_).removeHandler(self)
        super().close()


def test_task_affinity_matches_jax(monkeypatch, tmp_path):
    """Both packages' --task_affinity on the same seeded features (each
    package's extraction stubbed to return them), 10 epochs at lr 0.05:
    the test CE within 1e-4, the log lines equal."""
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(5, 24))
    # no class at exactly a fifth of the train rows: at the zero start its
    # bias gradient would be 0 but for rounding, which Adam's first step
    # g / (|g| + eps) turns into anything up to lr
    ytr = rng.permutation(np.repeat(np.arange(5), [16, 14, 11, 10, 9]))
    yte = rng.integers(0, 5, 30)
    xtr = (centers[ytr] + rng.normal(size=(60, 24))).astype(np.float32)
    xte = (centers[yte] + rng.normal(size=(30, 24))).astype(np.float32)
    feats = iter([(xtr, ytr), (xte, yte)] * 2)
    monkeypatch.setattr(jprobe, "extract_features", lambda *a, **k: next(feats))
    monkeypatch.setattr(probe, "extract_features",
                        lambda *a, **k: tuple(map(lambda v: torch.from_numpy(v)
                                                  if v.dtype == np.float32 else v, next(feats))))
    args = SimpleNamespace(ckpts=None, experiment_path=str(tmp_path))
    jlines, tlines = _Lines("t_aff_j"), _Lines("t_aff_t")
    want = jprobe.task_affinity(
        JConfigDict(_cfg({"NAME": "PointNet_NoT", "cls_dim": 5})), args,
        logger_name="t_aff_j", epochs=10, lr=0.05)
    got = probe.task_affinity(ConfigDict(_cfg({"NAME": "DGCNN_feat"})), args,
                              logger_name="t_aff_t", device="cpu", epochs=10, lr=0.05)
    jlines.close()
    tlines.close()
    assert abs(got - want) <= 1e-4 and got < np.log(5)
    assert tlines.lines[-2:] == jlines.lines[-2:]
    assert re.match(r"^\[Validation\] Acc: \d\.\d{4}  loss = \d+\.\d{4}$", tlines.lines[-1])


@pytest.fixture(scope="module")
def dgcnn_ckpt(tmp_path_factory):
    """A fine-tune DGCNN's weights (seed 3) in a .pth file: its encoder is
    what DGCNN_feat merges."""
    model = build_model_from_cfg(ConfigDict({"NAME": "DGCNN", "cls_dim": 5}), device="cpu",
                                 seed=3)
    path = tmp_path_factory.mktemp("probe_ck") / "ckpt-best.pth"
    torch.save({"base_model": model.state_dict()}, str(path))
    return str(path)


@pytest.mark.parametrize("mode", ["svm_classification", "task_affinity"])
def test_cli_probe_mode_end_to_end(mode, dgcnn_ckpt, tmp_path):
    """main_torch.py's route: the config from disk, the --ckpts merge (every
    encoder tensor, BatchNorm statistics included, and the unmatched head),
    the extraction, the mode's log lines."""
    cfg = _cfg({"NAME": "DGCNN_feat", "cls_dim": 5})
    for split in cfg["dataset"].values():
        split["_base_"] = str(tmp_path / "syn.yaml")
    (tmp_path / "syn.yaml").write_text(yaml.safe_dump(SYN))
    path = tmp_path / f"probe_{mode}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    lines = _Lines(f"probe_{mode}")
    out = cli.main(["--config", str(path), f"--{mode}", "--ckpts", dgcnn_ckpt,
                    "--root_folder", str(tmp_path / "exp")], device="cpu")
    lines.close()
    merged = [ln for ln in lines.lines if ln.startswith("[LOAD] merged")]
    keys = list(torch.load(dgcnn_ckpt)["base_model"])
    n_enc = sum(k.startswith("dgcnn_encoder.") for k in keys)
    assert merged == [f"[LOAD] merged {n_enc} tensors, {len(keys) - n_enc} unmatched"]
    if mode == "svm_classification":
        svm = [ln for ln in lines.lines if ln.startswith("[SVM]")]
        assert len(svm) == 7 and svm[-1] == f"[SVM] best acc = {out:.4f}"
        assert 0.0 <= out <= 100.0
    else:
        aff = [ln for ln in lines.lines if ln.startswith(("[TaskAffinity]", "[Validation]"))]
        assert len(aff) == 2 and aff[0].startswith(f"[TaskAffinity] test CE = {out:.4f} acc = ")
        assert np.isfinite(out) and out > 0
