"""The PointNet classes of the port (``models/dae_pointnet.py``) against the
JAX package on the CPU, at the JAX tests' size (B 4 of 256 points; the
widths are the classes' own). Every registered class in one jitted JAX
function (``_cnn_zoo.run_jax``), with the port's weights carried by
``to_flax``:
the DAEs' losses and the gradient of their sum in train and in eval mode
(``Point_CAE_PointNet`` under ``dropout_global``, whose draws come from a
fixed key on both sides; the part-seg-style DAE under the same
``corrupt_type``, which it ignores in both packages), the heads' logits in
train mode (the head's one dropout keep mask fed to both) and their logits
and the gradient of a cross-entropy in eval mode, the extractors' features
in eval mode, the running statistics after each train-mode forward (see
CASES for which gradients train mode holds). Then the
feature-transform encoder (``fstn``), the aliases by registry identity,
one AdamW step of ``Point_CAE_PointNet`` through ``make_train_step``
against the JAX train step, and the weight bridge both ways."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_draws as jd
from _cnn_zoo import (Case, bn_fed_biases, compare, global_dropout_draws, port_model, run_jax,
                      run_port, t)
from point_dae_tpu.engine.pretrain import make_train_step as j_make_train_step
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import MODELS as JMODELS
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import dae_pointnet as jpn
from point_dae_tpu.utils.config import ConfigDict as JConfigDict
from point_dae_tpu.utils.convert_torch import convert_state_dict

from point_dae_torch.engine.pretrain import StepDraws, make_train_step
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import MODELS, build_model_from_cfg
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.models.dae_pointnet import PointNetEncoder
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, CLS = 4, 256, 5
DROP = {"corrupt_type": ["dropout_global"]}
# In train mode a gradient that flows back through a BatchNorm over the
# batch's 4 rows (the heads' bn1 / bn2, the T-Net's f1 / f2) is
# ill-conditioned in f32: the two packages' train-mode gradients there part
# by 2e-4 to 3e-3 of a leaf's largest, and their logits by up to 7.5e-5 of
# the largest, each package about as far from a float64 run of the port;
# and a near-tie in the 2048-wide max over a cloud's points routes a
# column's gradient apart (the part-seg-style linear probe: 1.4e-2 of a
# leaf's largest on one seed). So the heads' train-mode logits are held
# within 1e-4 (as test_torch_linear_heads.py holds PointNet++'s), and every
# class's gradients in eval mode within 1e-4 (the DAEs without the T-Net in
# train mode too).
CASES = [Case("Point_CAE_PointNet", "Point_CAE_PointNet", "pretrain", cfg=DROP, grads=False),
         Case("Point_CAE_PointNet eval", "Point_CAE_PointNet", "pretrain", train=False),
         Case("Point_CAE_PointNet_NoT", "Point_CAE_PointNet_NoT", "pretrain"),
         Case("Point_CAE_PointNetNoT_PartSeg", "Point_CAE_PointNetNoT_PartSeg", "pretrain",
              cfg=DROP)]
CASES += [Case(f"{n} eval", n, "pretrain", train=False)
          for n in ("Point_CAE_PointNet_NoT", "Point_CAE_PointNetNoT_PartSeg")]
HEADS = ("PointNet", "PointNet_NoT", "PointNetNoT_Linear", "PointNetNoT_PartSeg",
         "PointNetNoT_Linear_PartSeg")
CASES += [Case(n, n, "head", cfg={"cls_dim": CLS}, tol=1e-4, grads=False) for n in HEADS]
CASES += [Case(f"{n} eval", n, "head", train=False, cfg={"cls_dim": CLS}) for n in HEADS]
CASES += [Case(n, n, "feat") for n in ("PointNet_feat", "PointNet_NoT_feat",
                                       "PointNetNoT_feat_PartSeg")]
REGISTERED = ("Point_CAE_PointNet", "Point_CAE_PointNet_NoT", "PointNet", "PointNet_NoT",
              "PointNet_feat", "PointNet_NoT_feat", "Point_CAE_PointNetNoT_PartSeg",
              "PointNetNoT_PartSeg", "PointNetNoT_Linear_PartSeg", "PointNetNoT_feat_PartSeg",
              "PointNetNoT_Linear", "Point_CAE_PointNetNoT", "PointNetNoT", "PointNetNoT_feat")
ALIASES = {"Point_CAE_PointNetNoT": "Point_CAE_PointNet_NoT", "PointNetNoT": "PointNet_NoT",
           "PointNetNoT_feat": "PointNet_NoT_feat"}


def clouds(rng, batch, n):
    """Gaussian clouds of another extent and centre each, as a batch of
    shapes differs."""
    x = rng.normal(size=(batch, n, 3)) * rng.uniform(0.2, 1.5, size=(batch, 1, 3))
    return (x + rng.uniform(-0.5, 0.5, size=(batch, 1, 3))).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(11)
    x = clouds(rng, B, N)
    y = (x + 0.05 * rng.normal(size=(B, N, 3))).astype(np.float32)
    return ({"x": x, "y": y, "labels": rng.integers(0, CLS, size=(B,))},
            {"dp": rng.uniform(size=(B, 256)) >= 0.4})


@functools.lru_cache(maxsize=None)
def _cases():
    """{key: (port result, JAX result)}, the JAX side one compile."""
    inputs, masks = _inputs()
    built = {}
    for i, c in enumerate(CASES):
        if c.name not in built:
            built[c.name] = port_model(c, seed=i)
    models = {c.key: copy.deepcopy(built[c.name]) for c in CASES}
    weights = {k: to_flax(m.state_dict()) for k, m in models.items()}
    want = run_jax(CASES, weights, {c.key: inputs for c in CASES},
                   {c.key: masks for c in CASES}, modules=(jpn,))
    got = {}
    for c in CASES:
        draws = None
        if c.kind == "head" and c.train:
            draws = ClsDraws([t(masks["dp"])])
        elif c.kind == "pretrain" and c.name == "Point_CAE_PointNet":
            draws = [global_dropout_draws(B, N, N // 2)]
        got[c.key] = run_port(c, models[c.key], inputs, draws)
    return got, want


@pytest.mark.parametrize("key", [c.key for c in CASES])
def test_class_matches_jax(key):
    got, want = _cases()
    compare(next(c for c in CASES if c.key == key), got[key], want[key])


def test_dropout_and_the_partseg_style_dae_ignoring_it():
    """``dropout_global`` moves the T-Net DAE's losses (against the same
    model without it); the part-seg-style DAE samples no draws for it."""
    inputs, _ = _inputs()
    x, y = t(inputs["x"]), t(inputs["y"])
    model = port_model(CASES[0], seed=0).train()
    same = port_model(Case("plain", "Point_CAE_PointNet", "pretrain"), seed=0).train()
    with torch.no_grad():
        dropped = float(model(x, y, draws=[global_dropout_draws(B, N, N // 2)])[0])
        plain = float(same(x, y)[0])
        assert plain != dropped
    ps = port_model(CASES[3], seed=3)
    assert ps.sample_draws(B, torch.Generator().manual_seed(0), "cpu") == []


def test_feature_transform_encoder_matches_jax():
    """The encoder with the 64 x 64 feature transform (``fstn``, which no
    class sets) in eval mode, its running statistics moved off their
    initial values: the feature within 1e-5 of its largest. (In train mode
    the two T-Nets' BatchNorms over 4 rows make the f32 feature
    ill-conditioned in both packages.)"""

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pointnet_encoder = PointNetEncoder(True, True, torch.Generator().manual_seed(3))

    holder = Holder()
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for n, b in holder.named_buffers():
            b.copy_(t(rng.uniform(0.5, 1.5, b.shape) if n.endswith("var")
                      else rng.normal(0, 0.1, b.shape)).float())
    params, stats = to_flax(holder.state_dict())
    x = clouds(rng, B, N)
    jenc = jpn.PointNetEncoder(use_tnet=True, feature_transform=True)
    want = jax.jit(lambda p, a: jenc.apply(
        {"params": p, "batch_stats": stats["pointnet_encoder"]}, a, train=False))(
        params["pointnet_encoder"], x)
    with torch.no_grad():
        got = holder.pointnet_encoder.eval()(t(x)).numpy()
    assert "fstn" in params["pointnet_encoder"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_every_pointnet_name_is_registered_and_aliases_are_the_same_class():
    jnames = {n for n in JMODELS.keys() if JMODELS.get(n).__module__ == jpn.__name__}
    assert jnames == set(REGISTERED)
    assert set(REGISTERED) <= set(MODELS.keys())
    for alias, name in ALIASES.items():
        assert MODELS.get(alias) is MODELS.get(name)
        assert JMODELS.get(alias) is JMODELS.get(name)


NRAW, NPOINTS, LR, STEP_B = 512, N, 1e-3, B


def _step_config():
    return {"optimizer": {"type": "AdamW", "part": "all",
                          "kwargs": {"lr": LR, "weight_decay": 0.05}},
            "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
            "dataset": {"train": {"others": {"npoints": NPOINTS, "aug_type": ["norm"],
                                             "corrupt_type": ["clean"]}}},
            "model": {"NAME": "Point_CAE_PointNet", "corrupt_type": [], "loss": "cdl2"},
            "npoints": NPOINTS, "total_bs": STEP_B, "max_epoch": 300, "loss_type": "xyznormal"}


def test_train_step_matches_jax():
    """One AdamW step of ``Point_CAE_PointNet`` through the port's
    ``make_train_step`` against the JAX train step, from the same weights,
    raw clouds and pipeline draws: both losses within 1e-5 relative, every
    running statistic within 1e-5 relative, every parameter element within
    Adam's bound of 2 lr. Adam's first update is lr * g / (|g| + 1e-8), so
    where two f32 gradients differ in sign the parameters part by 2 lr:
    outside the T-Net (whose train-mode gradient goes back through its
    BatchNorms over the batch's 4 rows, and whose c3 BatchNorm bias those
    cancel to zero but for rounding) and the biases before a BatchNorm (zero
    but for rounding), at most one element in 1e5 of a tensor (rounded up)
    may miss rtol 2e-3, as in the DGCNN step's test."""
    cfg = _step_config()
    rng = np.random.default_rng(7)
    raw = np.concatenate([clouds(rng, STEP_B, NRAW), rng.normal(size=(STEP_B, NRAW, 3))],
                         -1).astype(np.float32)
    key = jax.random.key(11)
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg))["model"], device="cpu", seed=4)
    init = to_flax(model.state_dict())
    jconfig = JConfigDict(copy.deepcopy(cfg))
    jmodel = j_build(jconfig["model"])
    tx, _ = j_build_optimizer(jconfig, init[0], steps_per_epoch=10)
    state = JTrainState.create(jmodel.apply, jax.tree_util.tree_map(jnp.asarray, init[0]),
                               jax.tree_util.tree_map(jnp.asarray, init[1]), tx)
    state, jm = j_make_train_step(jmodel, jconfig, mesh=None)(state, jnp.asarray(raw), key,
                                                              jnp.float32(0.0))
    jp = _flatten(jax.tree_util.tree_map(np.asarray, state.params))
    js = _flatten(jax.tree_util.tree_map(np.asarray, state.batch_stats))

    config = ConfigDict(copy.deepcopy(cfg))
    tstate = TrainState.create(model, config, steps_per_epoch=10)
    draws = jd.pipeline_draws(key, raw, ["norm"], ["clean"], NPOINTS)
    tm = make_train_step(model, config, device="cpu")(tstate, t(raw), draws=StepDraws(draws))
    tp, ts = (_flatten(tree) for tree in to_flax(model.state_dict()))
    for k in ("loss_xyz", "loss_normal"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert set(js) == set(ts) and set(jp) == set(tp)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-5 * np.abs(js[k]).max(),
                                   err_msg=k)
    start = _flatten(init[0])
    noise = bn_fed_biases(jp) | {k for k in jp if k.startswith("pointnet_encoder/stn/")}
    assert len(jp) - len(noise) == 15
    for k in jp:
        assert not np.array_equal(jp[k], start[k]), k
        assert np.abs(tp[k] - jp[k]).max() <= 2 * LR * (1 + 1e-4), k
        if k not in noise:
            close = np.isclose(tp[k], jp[k], rtol=2e-3, atol=5e-4)
            assert (~close).sum() <= np.ceil(1e-5 * close.size), (k, int((~close).sum()))


@pytest.mark.parametrize("name", ["Point_CAE_PointNet", "PointNet", "PointNet_NoT_feat",
                                  "Point_CAE_PointNetNoT_PartSeg", "PointNetNoT_PartSeg"])
def test_weights_carry_across_both_ways(name):
    """``to_flax`` gives the JAX model's paths and shapes; for the T-Net and
    NoT classes the reference converter's (family ``pointnet``)
    translation of the same tensors (its DAE decoder ``folding1`` becomes
    ``recfc``); the part-seg-style encoder, which that converter has no rules
    for, takes conv1-5 / bn1-5 to conv0-4 / bn0-4. ``from_flax`` inverts it
    bit for bit and loads strictly."""
    cfg = {"NAME": name, "cls_dim": CLS}
    model = build_model_from_cfg(ConfigDict(cfg), device="cpu", seed=1)
    sd = model.state_dict()
    params, stats = to_flax(sd)
    x = jnp.zeros((B, N, 3), jnp.float32)
    args = (x, x) if name.startswith("Point_CAE") else (x,)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "dropout", "corrupt"))}
    shapes = jax.eval_shape(lambda: j_build(JConfigDict(cfg)).init(rngs, *args, train=False))
    flat = lambda tree: {k: tuple(v.shape) for k, v in _flatten(jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, np.float32), dict(tree))).items()}
    assert flat(params) == flat(shapes["params"])
    assert flat(stats) == flat(shapes["batch_stats"])
    if "PartSeg" not in name:
        ref = convert_state_dict({k: v.numpy() for k, v in sd.items()}, family="pointnet")
        mine = {**_flatten(params), **_flatten(stats)}
        assert set(ref) == set(mine)
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    else:
        assert "pointnet_encoder.conv5.weight" in sd and "conv4" in params["pointnet_encoder"]
    back = from_flax(params, stats)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back, strict=True)
