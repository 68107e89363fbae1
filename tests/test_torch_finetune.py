"""The classification fine-tune path of the PyTorch port against the JAX
package on the CPU, at tiny widths: the resample, augmentation and losses;
``PointTransformer`` and ``DGCNN`` eval logits through ``from_flax``; two
f32 train steps of each family with the global-norm clip active and
inactive (same weights, same draws: the subset indices and scale/shift
recomputed from the JAX step's keys, the head's dropout masks fed to flax
through ``intercept_methods``, the stochastic-depth masks through
monkeypatch); the eval and vote steps; the warm start from a port pretrain
model and the converter's fine-tune rules."""
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_tpu.engine import finetune as jft
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.utils.config import ConfigDict as JConfigDict
from point_dae_tpu.utils.convert_torch import convert_state_dict

from point_dae_torch.engine import finetune as tft
from point_dae_torch.engine.train_state import TrainState, clip_by_global_norm_
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.utils.checkpoint import merge_pretrained, strip_prefixes
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, STEPS_PER_EPOCH, LR = 4, 10, 1e-3
_PT = {"NAME": "PointTransformer", "trans_dim": 64, "depth": 2, "drop_path_rate": 0.1,
       "cls_dim": 15, "num_heads": 2, "group_size": 8, "num_group": 16,
       "encoder_dims": 64}
_DG = {"NAME": "DGCNN", "cls_dim": 40}
# (model, raw points a cloud, npoints, smooth): the transformer resamples
# 1300 -> FPS 1200 -> a subset of 1024, as the ModelNet recipe does
FAMILIES = {"transformer": (_PT, 1300, 1024, True), "dgcnn": (_DG, 100, 64, False)}
# the widths of each family's head dropouts, by flax module name
_DROPOUTS = {"transformer": (("dp0", 512), ("dp1", 256)),
             "dgcnn": (("dp1", 512), ("dp2", 256))}


def _config(family, clip):
    model, _, npoints, _ = FAMILIES[family]
    return {"optimizer": {"type": "AdamW", "part": "all",
                          "kwargs": {"lr": LR, "weight_decay": 0.05}},
            "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
            "model": dict(model), "npoints": npoints, "total_bs": B, "max_epoch": 300,
            "grad_norm_clip": clip}


def _data(family, seed=7):
    _, n, _, _ = FAMILIES[family]
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, n, 3)).astype(np.float32)
    pts[0, 5] = 0.0                                       # never an FPS pick
    return pts, rng.integers(0, 15, size=(B,)).astype(np.int32), rng


@functools.lru_cache(maxsize=None)
def _j_init(family):
    """The JAX model and its init (params, batch_stats), made once a family."""
    model = j_build(JConfigDict(dict(FAMILIES[family][0])))
    pts = np.zeros((2, FAMILIES[family][2], 3), np.float32)
    v = jax.jit(lambda p: model.init({"params": jax.random.key(0)}, p, train=False))(pts)
    return model, jax.device_get((v["params"], v["batch_stats"]))


def _t_model(family, init):
    model = build_model_from_cfg(ConfigDict(dict(FAMILIES[family][0])), device="cpu")
    model.load_state_dict(from_flax(*init), strict=True)
    return model


def _subset(key, n_all, npoints):
    """The per-cloud choice ``jft.fps_resample`` draws from its key."""
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, n_all, (npoints,), replace=False))(jax.random.split(key, B)))


def _scale_shift(key):
    """The draws of ``jft.scale_translate(key, ...)``."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (B, 1, 3), minval=2. / 3., maxval=3. / 2.)),
            np.array(jax.random.uniform(k2, (B, 1, 3), minval=-0.2, maxval=0.2)))


# ------------------------------------------------------------------ pieces

def test_fps_resample_and_scale_translate_match_jax():
    """FPS 1300 -> 1200, then the JAX key's subset of 1024, bit for bit;
    scale-and-translate with the JAX key's draws, within one rounding."""
    pts, _, _ = _data("transformer")
    key = jax.random.key(3)
    want = jax.jit(lambda k, p: jft.fps_resample(k, p, 1024))(key, pts)
    sub = torch.from_numpy(_subset(key, 1200, 1024))
    got = tft.fps_resample(torch.from_numpy(pts), 1024, sub)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s, t = _scale_shift(key)
    want = jax.jit(jft.scale_translate)(key, want)
    got = tft.scale_translate(got, torch.from_numpy(s), torch.from_numpy(t))
    # XLA's CPU compiler may contract p * s + t into one fused multiply-add
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert tft.point_all(2048, 2048) == 2048 and tft.point_all(1024, 8192) == 1200


@pytest.mark.parametrize("smooth", [True, False])
def test_losses_match_jax(smooth):
    """f32 log-softmax sums in another order: 1e-6 relative."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(6, 15))).astype(np.float32)
    labels = rng.integers(0, 15, size=(6,)).astype(np.int32)
    jf, tf = ((jft.smooth_cross_entropy, tft.smooth_cross_entropy) if smooth
              else (jft.cross_entropy, tft.cross_entropy))
    want = float(jf(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tf(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    cfg = {"model": {"smoothloss": "True"}}
    assert tft.read_smooth(cfg) and not tft.read_smooth({"smooth": "False", **cfg})


def test_global_norm_clip_matches_optax():
    """optax's form, both sides of the trigger: exactly the same gradients
    where untouched, within f32 rounding of the norm where scaled."""
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    for max_norm in (0.5, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_logits_match_jax(family):
    """Eval forward through from_flax weights (BatchNorm on running
    statistics, here moved off their init values): f32 products summed in
    another order, 1e-4."""
    pts, _, rng = _data(family)
    pts = pts[:, :FAMILIES[family][2]]
    model, (params, stats) = _j_init(family)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, size=np.shape(a)).astype(np.float32),
        stats)
    want = jax.jit(lambda p: model.apply({"params": params, "batch_stats": stats}, p,
                                         train=False))(pts)
    tmodel = _t_model(family, (params, stats)).eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- train step

def _dropout_interceptor(masks):
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            return jnp.where(jnp.asarray(masks[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)
    return intercept


def _model_draws(family, rng):
    masks = {name: rng.uniform(size=(B, w)) >= 0.5 for name, w in _DROPOUTS[family]}
    dp = None
    if family == "transformer":
        dp = rng.uniform(size=(_PT["depth"], 2, B)) >= 0.3
        dp[-1, :, 0], dp[-1, :, 1] = False, True
    return masks, dp


def _run_jax(family, cfg, pts, labels, key, masks, dp, monkeypatch, steps):
    def dp_masks(mod, dpr, batch, deterministic):
        return None if deterministic or max(dpr) == 0.0 else jnp.asarray(dp)

    monkeypatch.setattr(jlayers, "_stack_dp_masks", dp_masks)
    config = JConfigDict(copy.deepcopy(cfg))
    model, init = _j_init(family)
    tx, _ = j_build_optimizer(config, init[0], STEPS_PER_EPOCH, config["grad_norm_clip"])
    state = JTrainState.create(model.apply, init[0], init[1], tx)
    step = jft.make_finetune_step(model, config, None, smooth=FAMILIES[family][3])
    with fnn.intercept_methods(_dropout_interceptor(masks)):
        for _ in range(steps):
            state, metrics = step(state, jnp.asarray(pts), jnp.asarray(labels), key)
    return init, jax.device_get((state.params, state.batch_stats, metrics))


def _run_torch(family, cfg, pts, labels, init, draws, steps):
    model = _t_model(family, init)
    config = ConfigDict(copy.deepcopy(cfg))
    state = TrainState.create(model, config, STEPS_PER_EPOCH, config["grad_norm_clip"])
    step = tft.make_finetune_step(model, config, smooth=FAMILIES[family][3], device="cpu")
    for _ in range(steps):
        m = step(state, torch.from_numpy(pts), torch.from_numpy(labels), draws=draws)
    params, stats = to_flax(model.state_dict())
    return _flatten(params), _flatten(stats), {k: float(v) for k, v in m.items()}


# Biases followed by a BatchNorm (the final LayerNorm's bias too: it shifts
# the cls output and the token max alike, in front of the head's first
# BatchNorm): their true gradient is exactly zero and what each framework
# computes is rounding noise, which Adam's update g / (|g| + eps) turns into
# up to lr a step in either direction. They are held to that bound.
_NULL_GRAD = {"transformer": ("encoder/conv1/bias", "encoder/conv2/bias",
                              "encoder/conv3/bias", "norm/bias",
                              "cls_head_finetune/fc0/bias",
                              "cls_head_finetune/fc1/bias"),
              "dgcnn": ("cls_head/fc1/bias", "cls_head/fc2/bias")}


@pytest.mark.parametrize("family,clip", [("transformer", 1e-5), ("transformer", 1e6),
                                         ("dgcnn", 1e-5)])
def test_train_step_f32_matches_jax(family, clip, monkeypatch):
    """One step. A clip of 1e-5 is active and leaves each gradient element
    near Adam's eps (1e-8), so the first update lr * g / (|g| + eps) tracks
    the clipped gradient and not only its sign; 1e6 is inactive. Loss and
    accuracy to 1e-4; every parameter to the flagship test's f32 tolerance
    (2e-3 relative, 5e-4 absolute), save that one element in 1e5 of a
    tensor may miss it within two Adam steps (without the clip, an element
    whose gradient is within rounding noise of zero moves by another
    fraction of lr); the BatchNorm running statistics to 1e-4 relative,
    1e-5 absolute. The DGCNN runs with the clip only: without it, Adam's
    sign step flips a few of its near-zero gradients (2 of ec1's 64 BN
    biases), and the clip is what the recipe runs."""
    steps = 1
    cfg = _config(family, clip)
    pts, labels, rng = _data(family)
    masks, dp = _model_draws(family, rng)
    key = jax.random.key(11)
    init, (jp, js, jm) = _run_jax(family, cfg, pts, labels, key, masks, dp,
                                  monkeypatch, steps)
    npoints = cfg["npoints"]
    n_all = tft.point_all(npoints, pts.shape[1])
    subset = None
    if n_all > npoints:
        subset = torch.from_numpy(_subset(jax.random.split(key, 3)[0], n_all, npoints))
    draws = tft.FinetuneDraws(subset, None, ClsDraws(
        [torch.from_numpy(masks[n]) for n, _ in _DROPOUTS[family]],
        None if dp is None else torch.from_numpy(dp)))
    tp, ts, tm = _run_torch(family, cfg, pts, labels, init, draws, steps)
    jp, js = (_flatten(jax.tree_util.tree_map(np.asarray, t)) for t in (jp, js))
    assert set(jp) == set(tp) and set(js) == set(ts)
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(tm["acc"], float(jm["acc"]), atol=1e-4)
    moved = _flatten(jax.tree_util.tree_map(np.asarray, init[0]))
    for k in sorted(jp):
        if k in _NULL_GRAD[family]:
            for got in (jp[k], tp[k]):
                assert np.abs(got - moved[k]).max() <= steps * LR * (1 + 1e-4), k
            continue
        close = np.isclose(tp[k], jp[k], rtol=2e-3, atol=5e-4)
        assert (~close).sum() <= np.ceil(1e-5 * close.size), (k, int((~close).sum()))
        assert np.abs(tp[k] - jp[k]).max() <= 2 * LR * (1 + 1e-4), k
    for k in sorted(js):      # head BatchNorms: sums of 256-512 f32 products
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_eval_and_vote_steps_match_jax():
    """The eval step (FPS 1300 -> 1024) and the 2-draw vote step (FPS 1200,
    the key's subsets and scale/shift draws) of the transformer; f32, 1e-4.
    The accuracy loop pads the tail batch."""
    cfg = _config("transformer", 10)
    pts, labels, _ = _data("transformer")
    model, init = _j_init("transformer")
    state = JTrainState.create(model.apply, init[0], init[1], optax.identity())
    key = jax.random.key(5)
    want_eval = jft.make_eval_step(model, JConfigDict(cfg))(state, jnp.asarray(pts))
    want_vote = jft.make_vote_step(model, JConfigDict(cfg), times=2)(
        state, jnp.asarray(pts), key)
    draws = []
    for k in jax.random.split(key, 2):
        k1, k2 = jax.random.split(k)
        s, t = _scale_shift(k2)
        draws.append(tft.FinetuneDraws(torch.from_numpy(_subset(k1, 1200, 1024)),
                                       (torch.from_numpy(s), torch.from_numpy(t))))
    tmodel = _t_model("transformer", init)
    eval_step = tft.make_eval_step(tmodel, cfg, device="cpu")
    got_eval = eval_step(torch.from_numpy(pts))
    got_vote = tft.make_vote_step(tmodel, cfg, times=2, device="cpu")(
        torch.from_numpy(pts), draws=draws)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_vote.numpy(), np.asarray(want_vote), rtol=1e-4, atol=1e-4)
    acc = tft.evaluate(eval_step, [{"points": pts[:3], "label": labels[:3]}], B)
    pred = np.asarray(want_eval)[:3].argmax(-1)
    assert acc == pytest.approx(100.0 * (pred == labels[:3]).mean())
    assert tft.pad_to_batch(pts[:3], B).shape == pts.shape


# ------------------------------------------------- warm start and converter

_PRETRAIN = {"transformer": None,       # _tiny_config's flagship, fold_impl xla
             "dgcnn": {"NAME": "Point_CAE_DGCNN_FCOnly", "loss": "cdl2",
                       "corrupt_type": ["affine_r3", "dropout_local"]}}


def _pretrain_model(family):
    if family == "dgcnn":
        cfg = _PRETRAIN["dgcnn"]
    else:
        cfg = _tiny_config()["model"]
        cfg["transformer_config"]["fold_impl"] = "xla"
    return build_model_from_cfg(ConfigDict(cfg), device="cpu", seed=3)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_merge_pretrained_transfers_the_encoder(family):
    """A port pretrain state dict, prefixes stripped, lands on the
    fine-tune model's encoder (BatchNorm statistics included); the decoder
    stays unmatched, and so does a tensor of the wrong shape."""
    pre = _pretrain_model(family).state_dict()
    pre = {k: v + 0.5 if k.endswith("running_var") else v for k, v in pre.items()}
    model = build_model_from_cfg(ConfigDict(dict(FAMILIES[family][0])), device="cpu")
    src = strip_prefixes({f"module.{k}": v for k, v in pre.items()})
    wrong = "blocks.blocks.0.mlp.fc1.weight" if family == "transformer" \
        else "dgcnn_encoder.conv5.0.weight"
    src[wrong] = torch.zeros(3, 3)
    misses = merge_pretrained(model, src)
    enc = ("encoder.", "pos_embed.", "blocks.", "norm.") if family == "transformer" \
        else ("dgcnn_encoder.",)
    own = model.state_dict()
    moved = [k for k in src if k.startswith(enc) and k != wrong]
    assert len(moved) >= (40 if family == "transformer" else 20)
    for k in moved:
        assert torch.equal(own[k], src[k]), k
    assert wrong in misses and not torch.equal(own[wrong][:3, :3], src[wrong])
    assert set(misses) == {k for k in src if not k.startswith(enc)} | {wrong}
    assert not any(k.startswith("cls_head_finetune") for k in src)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_rules_match_reference(family):
    """to_flax of a fine-tune model's state dict == convert_state_dict of
    the same tensors (family 'transformer' or 'dgcnn'); from_flax inverts
    it and loads strictly."""
    model = build_model_from_cfg(ConfigDict(dict(FAMILIES[family][0])), device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ref = {k: v for k, v in convert_state_dict(sd, family).items()
           if not k.endswith("num_batches_tracked")}
    params, stats = to_flax(sd)
    got = {**_flatten(params), **_flatten(stats)}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    back = from_flax(params, stats)
    model.load_state_dict(back, strict=True)
