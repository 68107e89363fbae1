"""The part-segmentation path of the PyTorch port against the JAX package on
the CPU, at tiny widths (N 128 points, B 4): the row scatter-add's plain
version against the VJP of ``gather_rows`` and against
``scatter_rows_add_pallas`` in interpret mode; ``three_nn`` and
``three_interpolate`` with their gradient; the eval log-probs of the three
part-segmentation models through ``from_flax``; one f32 train step of
``PointTransformerPartSeg`` and of ``DGCNNPartSeg`` with the same draws (the
scale and shift recomputed from the JAX step's key, the Dropout and
per-block DropPath masks fed to flax through ``intercept_methods``); the
category-restricted argmax and mIoU; the converter's round trip."""
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu.engine import partseg as jps
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.ops import geometry as jgeo
from point_dae_tpu.ops.pallas_scatter import gather_rows as j_gather_rows
from point_dae_tpu.ops.pallas_scatter import scatter_rows_add_pallas
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.engine import partseg as tps
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.partseg import SegDraws
from point_dae_torch.ops import geometry as tgeo
from point_dae_torch.ops.gather import gather_rows, scatter_rows_add, scatter_rows_add_plain
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

B, N, STEPS_PER_EPOCH, LR = 4, 128, 10, 1e-3
MODELS = {
    "transformer": {"NAME": "PointTransformerPartSeg", "trans_dim": 32, "depth": 4,
                    "drop_path_rate": 0.1, "cls_dim": 50, "num_heads": 2, "group_size": 8,
                    "num_group": 16, "encoder_dims": 32},
    "dgcnn": {"NAME": "DGCNNPartSeg", "cls_dim": 50},
    "pointnet": {"NAME": "PointNetNoTPartSeg", "cls_dim": 50},
}
# the widths of each model's head Dropouts, by flax module name
_DROPOUTS = {"transformer": (("dp1", 512),), "dgcnn": (("dp1", 256), ("dp2", 256))}


def _config(family):
    return {"optimizer": {"type": "AdamW", "part": "all",
                          "kwargs": {"lr": LR, "weight_decay": 0.05}},
            "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
            "model": dict(MODELS[family]), "npoints": N, "total_bs": B, "max_epoch": 300,
            "grad_norm_clip": 1e-5}


def _data(seed=7):
    """Clouds, category indices and per-point labels drawn from each
    category's parts."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    names = sorted(tps.SEG_CLASSES)
    labels = rng.integers(0, 16, size=(B,))
    seg = np.stack([rng.choice(tps.SEG_CLASSES[names[l]], size=N) for l in labels])
    onehot = np.eye(16, dtype=np.float32)[labels]
    return pts, labels, onehot, seg.astype(np.int32), rng


@functools.lru_cache(maxsize=None)
def _j_init(family):
    model = j_build(JConfigDict(dict(MODELS[family])))
    v = jax.jit(lambda p, c: model.init({"params": jax.random.key(0)}, p, c, train=False))(
        np.zeros((2, N, 3), np.float32), np.zeros((2, 16), np.float32))
    return model, jax.device_get((v["params"], v["batch_stats"]))


def _t_model(family, init):
    model = build_model_from_cfg(ConfigDict(dict(MODELS[family])), device="cpu")
    model.load_state_dict(from_flax(*init), strict=True)
    return model


# ------------------------------------------------------------ scatter-add

@pytest.mark.parametrize("Bs,Q,Nr,C", [(2, 50, 16, 8), (3, 300, 40, 33)])
def test_scatter_rows_add_plain_matches_jax(Bs, Q, Nr, C):
    """Duplicate indices and empty rows (the last quarter of the rows is
    never named). The plain version sums each element in ascending q:
    bit-equal to numpy's ``add.at``; against the VJP of JAX ``gather_rows``
    (an XLA scatter-add) and the Pallas one-hot kernel in interpret mode
    (a HIGHEST-precision product over 16-row chunks), f32 sums in another
    order: 1e-6 of the largest |out|. The port's ``gather_rows`` backward on
    the CPU is the same plain scatter; the kernel wrapper takes it for a CPU
    tensor."""
    rng = np.random.default_rng(Q)
    idx = rng.integers(0, 3 * Nr // 4, size=(Bs, Q)).astype(np.int32)
    g = rng.normal(size=(Bs, Q, C)).astype(np.float32)
    got = scatter_rows_add_plain(torch.from_numpy(idx), torch.from_numpy(g), Nr).numpy()
    want = np.zeros((Bs, Nr, C), np.float32)
    for b in range(Bs):
        np.add.at(want[b], idx[b], g[b])
    np.testing.assert_array_equal(got, want)
    assert not got[:, 3 * Nr // 4:].any()
    np.testing.assert_array_equal(
        scatter_rows_add(torch.from_numpy(idx), torch.from_numpy(g), Nr).numpy(), got)

    x = np.zeros((Bs, Nr, C), np.float32)
    _, vjp = jax.vjp(lambda x_: j_gather_rows(x_, jnp.asarray(idx)), jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        pallas = scatter_rows_add_pallas(jnp.asarray(idx), jnp.asarray(g), Nr, tq=16)
    top = np.abs(got).max()
    for ref in (vjp(jnp.asarray(g))[0], pallas):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6 * top)

    xt = torch.zeros((Bs, Nr, C), requires_grad=True)
    gather_rows(xt, torch.from_numpy(idx)).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), got)


def test_scatter_rows_add_plain_bf16_accumulates_in_f32():
    """A bf16 g is widened first: the f32 sums of the widened values, bit for
    bit, where a bf16 accumulation would round every partial sum."""
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, 4, size=(2, 200)))
    g = torch.from_numpy(rng.normal(size=(2, 200, 32)).astype(np.float32)).bfloat16()
    got = scatter_rows_add_plain(idx, g, 4)
    assert got.dtype == torch.float32
    assert torch.equal(got, scatter_rows_add_plain(idx, g.float(), 4))


# ----------------------------------------------------------- interpolation

def test_three_nn_and_three_interpolate_match_jax():
    """Squared distances and indices of the 3 nearest centres (stable order),
    then the inverse-distance interpolation and its gradient with respect to
    the features: f32 sums of 3 terms in the same order, 1e-5."""
    rng = np.random.default_rng(3)
    unknown = rng.normal(size=(B, N, 3)).astype(np.float32)
    known = rng.normal(size=(B, 16, 3)).astype(np.float32)
    feats = rng.normal(size=(B, 16, 24)).astype(np.float32)
    cot = rng.normal(size=(B, N, 24)).astype(np.float32)
    dj, ij = jax.jit(jgeo.three_nn)(unknown, known)
    dt, it = tgeo.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-6)

    def f(x):
        return jnp.sum(jgeo.three_interpolate(x, ij, dj) * cot)
    want, gwant = jax.jit(jax.value_and_grad(f))(feats)
    xt = torch.from_numpy(feats).requires_grad_()
    out = tgeo.three_interpolate(xt, it, dt)
    jout = jax.jit(jgeo.three_interpolate)(feats, ij, dj)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- models

@pytest.mark.parametrize("family", sorted(MODELS))
def test_eval_log_probs_match_jax(family):
    """Eval forward through from_flax weights, BatchNorm on running
    statistics moved off their init values: f32 products summed in another
    order, 1e-4 (relative and absolute) on log-probs of magnitude 1-10."""
    pts, _, onehot, _, rng = _data()
    model, (params, stats) = _j_init(family)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, size=np.shape(a)).astype(np.float32),
        stats)
    want = jax.jit(lambda p, c: model.apply({"params": params, "batch_stats": stats}, p, c,
                                            train=False))(pts, onehot)
    tmodel = _t_model(family, (params, stats))
    step = tps.make_seg_eval_step(tmodel, device="cpu")
    got = step(torch.from_numpy(pts), torch.from_numpy(onehot))
    assert got.shape == (B, N, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _interceptor(dropout, drop_path):
    """flax Dropout -> the given keep masks by module name; per-block
    DropPath of block i -> drop_path[i, 0] (``dp1``) or [i, 1] (``dp2``)."""
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (context.method_name != "__call__"
                or not isinstance(mod, (fnn.Dropout, jlayers.DropPath))
                or kwargs.get("deterministic", args[1] if len(args) > 1 else True)):
            return next_fun(*args, **kwargs)
        if isinstance(mod, fnn.Dropout):
            return jnp.where(jnp.asarray(dropout[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        if mod.rate != 0.0:
            i = int(mod.parent.name[len("block"):])
            keep = jnp.asarray(drop_path[i, int(mod.name[-1]) - 1])
            x = args[0]
            return jnp.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)), x / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)
    return intercept


@pytest.mark.parametrize("family", ["dgcnn", "transformer"])
def test_seg_train_step_f32_matches_jax(family):
    """One step with an active clip of 1e-5: each gradient element lies
    near Adam's eps, so an element moves by lr g / (|g| + eps), a smooth
    function of its gradient (median move by tensor 0.01 to 0.9 lr). Loss
    and accuracy to 1e-4. For each parameter tensor the gap between the two
    packages' new values: median and mean within 1e-3 lr, largest within
    1e-2 lr (read: at most 5e-6, 1.2e-5 and 1.2e-4 lr, the last one f32
    rounding of a value near 1; a row-gather backward 1.1 times too large
    puts a tensor's median gap at 2e-3 lr or more). The BatchNorm running
    statistics to 1e-4 relative, 1e-5 absolute."""
    cfg = _config(family)
    pts, _, onehot, seg, rng = _data()
    dropout = {name: rng.uniform(size=(B, N, w)) >= 0.5 for name, w in _DROPOUTS[family]}
    depth = MODELS[family].get("depth")
    dp = None if depth is None else rng.uniform(size=(depth, 2, B)) >= 0.3
    key = jax.random.key(11)

    config = JConfigDict(copy.deepcopy(cfg))
    model, init = _j_init(family)
    tx, _ = j_build_optimizer(config, init[0], STEPS_PER_EPOCH, config["grad_norm_clip"])
    state = JTrainState.create(model.apply, init[0], init[1], tx)
    step = jps.make_seg_train_step(model, config)
    with fnn.intercept_methods(_interceptor(dropout, dp)):
        state, jm = step(state, jnp.asarray(pts), jnp.asarray(onehot), jnp.asarray(seg), key)
    jp, js = (_flatten(jax.tree_util.tree_map(np.asarray, t))
              for t in jax.device_get((state.params, state.batch_stats)))

    k1, k2 = jax.random.split(jax.random.split(key, 3)[0])
    scale = np.array(jax.random.uniform(k1, (B, 1, 1), minval=0.8, maxval=1.25))
    shift = np.array(jax.random.uniform(k2, (B, 1, 3), minval=-0.1, maxval=0.1))
    draws = SegDraws(torch.from_numpy(scale), torch.from_numpy(shift),
                     None if dp is None else torch.from_numpy(dp),
                     [torch.from_numpy(dropout[n]) for n, _ in _DROPOUTS[family]])
    tmodel = _t_model(family, init)
    tconfig = ConfigDict(copy.deepcopy(cfg))
    tstate = TrainState.create(tmodel, tconfig, STEPS_PER_EPOCH, tconfig["grad_norm_clip"])
    tm = tps.make_seg_train_step(tmodel, device="cpu")(
        tstate, torch.from_numpy(pts), torch.from_numpy(onehot), torch.from_numpy(seg),
        draws=draws)
    tp, ts = (_flatten(t) for t in to_flax(tmodel.state_dict()))

    assert set(jp) == set(tp) and set(js) == set(ts)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]), atol=1e-4)
    for k in sorted(jp):
        gap = np.abs(tp[k] - jp[k])
        assert np.median(gap) <= 1e-3 * LR, (k, float(np.median(gap)) / LR)
        assert gap.mean() <= 1e-3 * LR, (k, float(gap.mean()) / LR)
        assert gap.max() <= 1e-2 * LR, (k, float(gap.max()) / LR)
    for k in sorted(js):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_seg_draws_sample():
    """A train forward without draws takes them from the generator: the
    scale and shift in their ranges, keep masks of the model's shapes."""
    model = build_model_from_cfg(ConfigDict(dict(MODELS["transformer"])), device="cpu")
    d = SegDraws.sample(model, B, N, torch.Generator().manual_seed(0), "cpu")
    assert d.scale.shape == (B, 1, 1) and d.shift.shape == (B, 1, 3)
    assert 0.8 <= float(d.scale.min()) and float(d.scale.max()) <= 1.25
    assert float(d.shift.abs().max()) <= 0.1
    assert d.drop_path.shape == (4, 2, B) and [m.shape for m in d.dropout] == [(B, N, 512)]
    pts, _, onehot, _, _ = _data()
    model.train()
    out = model(torch.from_numpy(pts), torch.from_numpy(onehot),
                generator=torch.Generator().manual_seed(1))
    assert out.shape == (B, N, 50) and bool(torch.isfinite(out).all())


# -------------------------------------------------------------------- mIoU

def test_miou_and_restricted_argmax_match_jax():
    """Random log-probs over all 50 parts: the category-restricted argmax
    and the instance, class and per-class mIoU equal JAX's; the eval loop
    pads a short tail batch and gives the same mIoU."""
    rng = np.random.default_rng(5)
    names = sorted(tps.SEG_CLASSES)
    labels = rng.integers(0, 16, size=(6,))
    cats = [names[l] for l in labels]
    logp = rng.normal(size=(6, 64, 50)).astype(np.float32)
    seg = np.stack([rng.choice(tps.SEG_CLASSES[c], size=64) for c in cats])
    pred = tps.category_restricted_argmax(logp, cats)
    np.testing.assert_array_equal(pred, jps.category_restricted_argmax(logp, cats))
    assert all(set(pred[b]) <= set(tps.SEG_CLASSES[c]) for b, c in enumerate(cats))
    got, want = tps.compute_miou(pred, seg, cats), jps.compute_miou(pred, seg, cats)
    assert got == want and 0.0 < got["instance_miou"] < 1.0

    batches = [{"points": rng.normal(size=(4, 64, 3)), "label": labels[:4], "seg": seg[:4]},
               {"points": rng.normal(size=(2, 64, 3)), "label": labels[4:], "seg": seg[4:]}]
    padded = [logp[:4], np.concatenate([logp[4:], np.zeros((2, 64, 50), np.float32)])]
    seen = []

    def eval_step(p, c):
        seen.append((tuple(p.shape), c.argmax(-1).tolist()))
        return torch.from_numpy(padded[len(seen) - 1])

    m = tps.evaluate_partseg(eval_step, batches, 4, names)
    assert seen == [((4, 64, 3), labels[:4].tolist()),
                    ((4, 64, 3), labels[4:].tolist() + [0, 0])]
    assert m == want


# -------------------------------------------------------------- converter

@pytest.mark.parametrize("family", sorted(MODELS))
def test_converter_round_trip(family):
    """JAX init tree -> from_flax -> strict load -> to_flax: the same tree,
    exactly, batch statistics included."""
    _, (params, stats) = _j_init(family)
    model = _t_model(family, (params, stats))
    tp, ts = to_flax(model.state_dict())
    for got, want in ((tp, params), (ts, stats)):
        g, w = _flatten(got), _flatten(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
