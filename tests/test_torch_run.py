"""The port's run layer on the CPU at tiny sizes: the schedules, the SVM
probe against sklearn (through the JAX package's ``evaluate_svm``),
checkpoint files read by the JAX package, the CLI against the JAX CLI for
the same argv, and the runs (pretrain with a resume, fine-tune and test,
part segmentation and test) with their log lines in the JAX formats."""
import logging
import math
import os
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_tpu import cli as jcli
from point_dae_tpu.engine import pretrain as jpt
from point_dae_tpu.engine.train_state import make_lr_schedule as j_lr
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.utils.checkpoint import load_torch_checkpoint
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch import cli
from point_dae_torch.engine import finetune, partseg, pretrain
from point_dae_torch.engine.train_state import TrainState, make_lr_schedule
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.utils.checkpoint import resume_checkpoint, save_checkpoint
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, to_flax

from _torch_files import partseg_tree

SYN = {"NAME": "Synthetic", "N_POINTS": 128, "num_classes": 5, "with_normal": True}
OTH = {"subset": "train", "npoints": 64, "size": 16}
OPT = {"optimizer": {"type": "AdamW", "part": "all",
                     "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
       "scheduler": {"type": "CosLR", "kwargs": {"epochs": 3, "initial_epochs": 0}}}
TRAINING = re.compile(r"^\[Training\] EPOCH: (\d+) EpochTime = \d+\.\d{3} \(s\) "
                      r"Losses = \['-?\d+\.\d{4}', '-?\d+\.\d{4}'\]$")


def _split(**over):
    return {"_base_": dict(SYN), "others": dict(OTH, **over)}


def _args(tmp_path, **over):
    d = dict(seed=0, experiment_path=str(tmp_path), tfboard_path=None, val_freq=1,
             resume=False, auto_resume=False, start_ckpts=None, ckpts=None, vote=False)
    d.update(over)
    return SimpleNamespace(**d)


class _Lines(logging.Handler):
    def __init__(self, name):
        super().__init__()
        self.lines = []
        self.name_ = name
        logging.getLogger(name).addHandler(self)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def close(self):
        logging.getLogger(self.name_).removeHandler(self)
        super().close()


@pytest.mark.parametrize("loss_type", ["xyz", "xyznormal", "xyznormal_gradual",
                                       "xyznormal_warm"])
def test_gradual_weight_matches_jax(loss_type):
    for epoch in (0, 1, 7, 30, 99, 100):
        assert pretrain.gradual_weight_for(loss_type, epoch, 100) == \
            jpt.gradual_weight_for(loss_type, epoch, 100)


@pytest.mark.parametrize("sched", [{"epochs": 10}, {"epochs": 10, "warmup_epochs": 3},
                                   {"epochs": 6, "min_lr": 1e-5, "t_max": 4}])
def test_lr_per_step_matches_jax(sched):
    config = {"optimizer": {"type": "AdamW", "kwargs": {"lr": 2e-3}},
              "scheduler": {"type": "CosLR", "kwargs": sched}, "max_epoch": 10}
    t, j = make_lr_schedule(config, 7), j_lr(config, 7)
    for step in range(0, 80, 3):
        assert math.isclose(t(step), float(j(step)), rel_tol=1e-6), step


@pytest.mark.parametrize("classes,n,dim", [(2, 300, 24), (15, 450, 40)])
def test_svm_matches_sklearn(classes, n, dim):
    """Decision values within 1e-3 of sklearn's largest (its default tol
    1e-4 stops short of the optimum the port's Newton solve reaches);
    predictions equal but where sklearn's top-two margin is within that."""
    from sklearn.svm import LinearSVC as SkSVC

    rng = np.random.default_rng(classes)
    centers = rng.normal(size=(classes, dim))
    y = rng.integers(0, classes, n)
    x = (0.6 * centers[y] + rng.normal(size=(n, dim))).astype(np.float32)
    yt = rng.integers(0, classes, 120)
    xt = (0.6 * centers[yt] + rng.normal(size=(120, dim))).astype(np.float32)
    assert pretrain.evaluate_svm(x, y, xt, yt, device="cpu") == \
        jpt.evaluate_svm(x, y, xt, yt)
    sk = SkSVC(C=0.01).fit(x, y)
    port = pretrain.LinearSVC(C=0.01, device="cpu").fit(x, y)
    ds, dp = sk.decision_function(xt), port.decision_function(xt).numpy()
    tol = 1e-3 * np.abs(ds).max()
    assert np.abs(ds - dp).max() <= tol
    pred_s, pred_p = sk.predict(xt), port.predict(xt).numpy()
    if classes == 2:
        near = np.abs(ds) <= tol
    else:
        top2 = np.sort(ds, 1)[:, -2:]
        near = top2[:, 1] - top2[:, 0] <= 2 * tol
    assert ((pred_s == pred_p) | near).all()


def test_svm_tensor_features_and_labels():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(60, 8)))
    y = np.repeat(np.arange(3), 20)
    x[:, 0] += torch.from_numpy(y * 3.0)
    assert pretrain.evaluate_svm(x, y, x, y, device="cpu") == \
        jpt.evaluate_svm(x.numpy(), y, x.numpy(), y)


def _dgcnn_model():
    return {"NAME": "Point_CAE_DGCNN_FCOnly", "corrupt_type": [], "loss": "cdl2"}


@pytest.mark.parametrize("family", ["transformer", "dgcnn"])
def test_checkpoint_read_by_the_jax_package(tmp_path, family):
    """A port ckpt-last.pth: JAX's ``load_torch_checkpoint`` reads every
    tensor; through ``to_flax`` it is the JAX model's tree, key for key,
    shape for shape, tensor for tensor."""
    cfg = _tiny_config() if family == "transformer" else dict(OPT, model=_dgcnn_model())
    cfg = ConfigDict(cfg)
    model = build_model_from_cfg(cfg["model"], device="cpu", seed=3)
    save_checkpoint(str(tmp_path), "ckpt-last", TrainState.create(model, cfg, 10), 2, 0.5)
    path = str(tmp_path / "ckpt-last.pth")
    sd = model.state_dict()
    flat = load_torch_checkpoint(path)
    stripped = {k[len("MAE_encoder."):] if k.startswith("MAE_encoder.") else k: v
                for k, v in sd.items()}
    assert set(flat) == set(stripped)
    for k, v in stripped.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    params, stats = to_flax(torch.load(path, weights_only=True)["base_model"])
    jm = j_build(JConfigDict(cfg)["model"])
    pts = np.zeros((2, 128 if family == "transformer" else 64, 3), np.float32)
    rngs = {"params": jax.random.key(0), "mask": jax.random.key(1),
            "corrupt": jax.random.key(2)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, pts, pts, train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {**_flatten(zeros["params"]), **_flatten(zeros["batch_stats"])}
    got = {**_flatten(params), **_flatten(stats)}
    assert set(got) == set(want)
    ref_p, ref_s = to_flax(sd)
    ref = {**_flatten(ref_p), **_flatten(ref_s)}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_load_params_forms_and_key_diff(tmp_path):
    """``load_params`` takes (dir, name) or a path in both arguments, with
    or without ``.pth``, strips ``module.`` and refuses a directory;
    ``flatten_keys`` and ``report_key_diff`` are the JAX package's."""
    from point_dae_tpu.utils import checkpoint as jck

    from point_dae_torch.utils.checkpoint import flatten_keys, load_params, report_key_diff

    sd = {"module.a.weight": torch.ones(2), "b": torch.zeros(1)}
    torch.save({"model": sd}, tmp_path / "released.pth")
    for args in ((str(tmp_path), "released"), (str(tmp_path / "released.pth"),) * 2,
                 (str(tmp_path / "released"),) * 2):
        got = load_params(*args)
        assert set(got) == {"a.weight", "b"} and torch.equal(got["a.weight"], sd["module.a.weight"])
    (tmp_path / "ckpt-orbax").mkdir()
    with pytest.raises(ValueError, match="directory"):
        load_params(str(tmp_path), "ckpt-orbax")
    with pytest.raises(FileNotFoundError):
        load_params("nowhere.pth", "nowhere.pth")
    tree = {"enc": {"w": 1, "b": {"x": 2}}, "head": 3}
    other = {"enc": {"w": 1}, "extra": {"y": 4}}
    assert flatten_keys(tree) == jck.flatten_keys(tree)
    assert report_key_diff(tree, other) == jck.report_key_diff(tree, other)


ARGVS = {
    "pretrain": ["--exp_name", "a", "--seed", "3", "--total_bs", "4"],
    "model_name": ["--model_name", "Point_CAE_DGCNN_FCOnly", "--exp_name", "b"],
    "test": ["--test", "--ckpts", "x.pth", "--finetune_model", "--mode", "hard"],
    "corruption": ["--test_corruption", "--ckpts", "x.pth"],
    "fewshot": ["--finetune_model", "--way", "5", "--shot", "10", "--fold", "2"],
    "none_sentinel": ["--model_name", "none", "--vote", "--resume"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_cli_args_and_config_match_jax(tmp_path, case):
    cfg = "cfgs/pretrain_synthetic_dgcnn.yaml" if case != "fewshot" \
        else "cfgs/finetune_synthetic_transformer.yaml"
    argv = ["--config", cfg, "--root_folder", str(tmp_path)] + ARGVS[case]
    ja = jcli.get_args(argv)
    jc = jcli.load_config(ja)
    saved = open(os.path.join(ja.experiment_path, "config.yaml")).read()
    os.remove(os.path.join(ja.experiment_path, "config.yaml"))
    ta = cli.get_args(argv)
    assert vars(ta) == vars(ja)
    tc = cli.load_config(ta)
    assert open(os.path.join(ta.experiment_path, "config.yaml")).read() == saved
    assert tc == jc


@pytest.mark.parametrize("argv,msg", [
    (["--test", "--resume", "--ckpts", "x"], "exclusive"),
    (["--resume", "--start_ckpts", "x"], "exclusive"),
    (["--test"], "ckpts shouldn't be None")])
def test_cli_validations_match_jax(tmp_path, argv, msg):
    argv = ["--config", "cfgs/pretrain_synthetic_dgcnn.yaml", "--root_folder",
            str(tmp_path)] + argv
    with pytest.raises(ValueError, match=msg) as je:
        jcli.get_args(argv)
    with pytest.raises(ValueError, match=msg) as te:
        cli.get_args(argv)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("flags", [["--test_corruption", "--ckpts", "x"],
                                   ["--so3_rotation"], ["--vis_saliency"],
                                   ["--svm_classification"], ["--task_affinity"],
                                   ["--test", "--ckpts", "x"]])
def test_cli_modes_not_ported_raise(tmp_path, flags):
    argv = ["--config", "cfgs/pretrain_synthetic_dgcnn.yaml", "--root_folder",
            str(tmp_path)] + flags
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        cli.main(argv, device="cpu")


def test_cli_refuses_the_cpu_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", "cfgs/pretrain_synthetic_dgcnn.yaml",
                  "--root_folder", str(tmp_path)])
    assert not os.listdir(tmp_path)


def _pretrain_cfg(max_epoch, **extra):
    return ConfigDict(dict(OPT, dataset={"train": _split(), **extra},
                           model=_dgcnn_model(), normal_weight=1.0, npoints=64,
                           total_bs=8, max_epoch=max_epoch, loss_type="xyz"))


def test_pretrain_resume_continues_epochs(tmp_path):
    """tests/test_cli_modes.py:144-175 in the port: 2 epochs of 2 steps,
    then a resume that runs one more epoch from the saved optimizer state,
    step count and schedule position; SVM validation each epoch."""
    probe = {"val": _split(subset="test", size=8, seed=1),
             "extra_train": _split(size=8, seed=2)}
    lines = _Lines("t_pre1")
    out1 = pretrain.run_pretrain(_pretrain_cfg(1, **probe), _args(tmp_path),
                                 logger_name="t_pre1", device="cpu")
    lines.close()
    assert out1["state"].step == 4
    train = [TRAINING.match(ln) for ln in lines.lines if ln.startswith("[Training]")]
    assert [int(m.group(1)) for m in train] == [0, 1]
    val = [ln for ln in lines.lines if ln.startswith("[Validation]")]
    assert len(val) == 2 and all(re.match(r"^\[Validation\] EPOCH: \d+  acc = \d\.\d{4}$", v)
                                 for v in val)
    assert {"ckpt-best.pth", "ckpt-last.pth"} <= set(os.listdir(tmp_path))

    saved = torch.load(tmp_path / "ckpt-last.pth", weights_only=True)
    fresh = build_model_from_cfg(_pretrain_cfg(2)["model"], device="cpu", seed=5)
    st, start, _ = resume_checkpoint(str(tmp_path), TrainState.create(fresh, _pretrain_cfg(2), 2))
    assert (start, st.step) == (2, 4)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved["base_model"][k]), k
    moments = st.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        assert torch.equal(moments[i]["exp_avg_sq"], s["exp_avg_sq"])

    lines = _Lines("t_pre2")
    out2 = pretrain.run_pretrain(_pretrain_cfg(2), _args(tmp_path, resume=True),
                                 logger_name="t_pre2", device="cpu")
    lines.close()
    assert out2["state"].step == 6
    assert [int(TRAINING.match(ln).group(1)) for ln in lines.lines
            if ln.startswith("[Training]")] == [2]
    assert torch.load(tmp_path / "ckpt-last.pth", weights_only=True)["epoch"] == 2


def test_pretrain_device_cache_and_start_ckpts(tmp_path):
    first = tmp_path / "first"
    pretrain.run_pretrain(_pretrain_cfg(0), _args(first), logger_name="t_pc", device="cpu")
    cfg = _pretrain_cfg(0)
    cfg["dataset"]["train"]["others"].update(device_cache=True, size=20)
    cfg["steps_per_dispatch"] = 4
    lines = _Lines("t_pc2")
    out = pretrain.run_pretrain(cfg, _args(tmp_path / "second",
                                           start_ckpts=str(first / "ckpt-last.pth")),
                                logger_name="t_pc2", device="cpu")
    lines.close()
    assert out["state"].step == 2                    # floor(20 / 8)
    assert any("merged" in ln for ln in lines.lines)
    assert any("steps_per_dispatch 4" in ln for ln in lines.lines)


_PT = {"NAME": "PointTransformer", "trans_dim": 32, "depth": 1, "drop_path_rate": 0.1,
       "cls_dim": 5, "num_heads": 2, "group_size": 8, "num_group": 8, "encoder_dims": 32}


def test_finetune_and_test_net(tmp_path):
    cfg = ConfigDict(dict(OPT, dataset={"train": _split(), "val": _split(subset="test", size=8),
                                        "test": _split(subset="test", size=8)},
                          model=dict(_PT), npoints=64, total_bs=8, max_epoch=1,
                          grad_norm_clip=10, smooth="True"))
    lines = _Lines("t_ft")
    out = finetune.run_finetune(cfg, _args(tmp_path), logger_name="t_ft", device="cpu")
    assert out["state"].step == 4
    train = [ln for ln in lines.lines if ln.startswith("[Training]")]
    assert [int(TRAINING.match(ln).group(1)) for ln in train] == [0, 1]
    val = [ln for ln in lines.lines if ln.startswith("[Validation]")]
    assert len(val) == 2 and all(
        re.match(r"^\[Validation\] EPOCH: \d+  acc = \d+\.\d{4} time = \d+\.\ds$", v)
        for v in val)
    assert (tmp_path / "ckpt-last.pth").exists()
    ckpt = str(tmp_path / "ckpt-last.pth")
    acc = finetune.test_net(cfg, _args(tmp_path, ckpts=ckpt, vote=True, vote_repeats=2),
                            logger_name="t_ft", device="cpu")
    lines.close()
    assert 0.0 <= acc <= 100.0
    assert any(re.match(r"^\[TEST\] acc = \d+\.\d{4}$", ln) for ln in lines.lines)
    votes = [ln for ln in lines.lines if ln.startswith("[TEST_VOTE]")]
    assert [int(re.match(r"^\[TEST_VOTE\] iter (\d+): acc = \d+\.\d{4} best = \d+\.\d{4}$",
                         v).group(1)) for v in votes] == [0, 1]


def test_partseg_and_test_partseg(tmp_path):
    (tmp_path / "data").mkdir()
    base = dict(partseg_tree(tmp_path / "data", per_cat=6, rows=80), npoints=64)
    model = {"NAME": "PointTransformerPartSeg", "trans_dim": 16, "depth": 4,
             "drop_path_rate": 0.1, "cls_dim": 50, "num_heads": 2, "group_size": 8,
             "num_group": 8, "encoder_dims": 16}
    cfg = ConfigDict(dict(OPT, dataset={"train": {"_base_": base, "others": {"subset": "trainval"}},
                                        "test": {"_base_": base, "others": {"subset": "test"}}},
                          model=model, npoints=64, total_bs=4, max_epoch=0, grad_norm_clip=10))
    exp = tmp_path / "exp"
    lines = _Lines("t_ps")
    out = partseg.run_partseg(cfg, _args(exp), logger_name="t_ps", device="cpu")
    assert 0.0 <= out["best_instance_miou"] <= 1.0
    epoch = [ln for ln in lines.lines if not ln.startswith("[LOAD]")][-5:]
    assert re.match(r"^Epoch 0 train loss = \d+\.\d{5} train acc = \d\.\d{5}$", epoch[0])
    assert re.match(r"^Epoch 0 test inctance avg mIOU = \d\.\d{5} class avg mIOU = \d\.\d{5} "
                    r"time = \d+\.\ds$", epoch[1])
    assert re.match(r"^Best inctance avg mIOU is: \d\.\d{5}$", epoch[2])
    assert re.match(r"^Best class avg mIOU is: \d\.\d{5}$", epoch[3])
    assert epoch[4].startswith("Saved checkpoint at ") and epoch[4].endswith("best_model.pth")
    m = partseg.test_partseg(cfg, _args(exp, ckpts=str(exp / "best_model.pth")),
                             logger_name="t_ps", device="cpu")
    lines.close()
    assert lines.lines[-1] == (f"[TEST] test inctance avg mIOU = {m['instance_miou']:.5f} "
                               f"class avg mIOU = {m['class_miou']:.5f}")
    assert lines.lines[-2].endswith(" 0 unmatched")      # every tensor of best_model
    assert 0.0 <= m["instance_miou"] <= 1.0
