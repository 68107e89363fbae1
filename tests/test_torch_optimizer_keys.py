"""The engine's keys that the PointCAE heads' slice ports, against the JAX
package on the CPU: ``chamfer_l2_coarse2fine`` (values and gradients), one
supervised pretrain step (``PointCAE_transformer_supervised`` at a tiny
width, labels threaded through the step) under a ``bnmscheduler`` (loss,
every parameter, the re-blended running statistics), the schedulers
(``LambdaLR``, ``StepLR``, ``function``, ``CosLR`` under ``step_per_update:
2``) at many steps, and four mini-steps of ``step_per_update: 2`` with a
clip against optax's ``MultiSteps`` (the parameters after each)."""
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_flagship as tf
from __graft_entry__ import _tiny_config
from point_dae_tpu.data import corruptions_patch as jcp
from point_dae_tpu.engine.pretrain import make_train_step as j_make_train_step
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer,
                                              make_lr_schedule as j_lr)
from point_dae_tpu.losses import chamfer_l2_coarse2fine as j_c2f
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.data.corruptions_patch import AffineR3Draws
from point_dae_torch.engine.pretrain import (PipelineDraws, StepDraws, bn_momentum_for,
                                             make_train_step)
from point_dae_torch.engine.train_state import TrainState, make_lr_schedule
from point_dae_torch.losses.chamfer import chamfer_l2_coarse2fine
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import SupervisedDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, NRAW, SPE = tf.B, tf.NRAW, 10
BN_SCHED = {"kwargs": {"bn_momentum": 0.1, "bn_decay": 0.5, "decay_step": 2,
                       "lowest_decay": 0.01}}
EPOCH = 2                              # momentum 0.05: each move half flax's 0.1


def _t(a):
    return torch.from_numpy(np.array(a))


def test_coarse2fine_matches_jax():
    """(centre term, fine term) within 1e-6 relative; the gradients of
    both predicted inputs (the fine one through the gather by the
    centres' matches) within 1e-5 of their largest."""
    rng = np.random.default_rng(2)
    xyz1, xyz2 = (rng.normal(size=(3, 16, 3)).astype(np.float32) for _ in range(2))
    fine1, fine2 = (rng.normal(size=(3, 16, 8, 3)).astype(np.float32) for _ in range(2))
    (jc, jf), vjp = jax.vjp(lambda a, b: j_c2f(a, jnp.asarray(xyz2), b, jnp.asarray(fine2)),
                            jnp.asarray(xyz1), jnp.asarray(fine1))
    ja, jb = vjp((jnp.float32(1.0), jnp.float32(1.0)))
    a, b = _t(xyz1).requires_grad_(), _t(fine1).requires_grad_()
    c, f = chamfer_l2_coarse2fine(a, _t(xyz2), b, _t(fine2))
    (c + f).backward()
    np.testing.assert_allclose([float(c), float(f)], [float(jc), float(jf)], rtol=1e-6)
    for got, want in ((a.grad, ja), (b.grad, jb)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _sup_config():
    cfg = _tiny_config()
    cfg["model"]["NAME"] = "PointCAE_transformer_supervised"
    cfg["model"]["transformer_config"].update(trans_dim=32, encoder_dims=32)
    del cfg["model"]["transformer_config"]["dtype"]
    cfg["bnmscheduler"] = BN_SCHED
    return cfg


@functools.lru_cache(maxsize=None)
def _supervised_step():
    """(initial flat params, JAX loss, params, stats; the port's loss,
    params, stats; the port's stats after the same step without the
    bnmscheduler) of one supervised step from the same weights, batch,
    labels and draws."""
    cfg = _sup_config()
    rng = np.random.default_rng(6)
    raw = rng.normal(size=(B, NRAW, 6)).astype(np.float32)
    labels = rng.integers(0, 55, B)
    mask, affine, dp_enc = tf._draws(cfg, rng)
    drop = {f"dp{i}": rng.uniform(size=(B, 256)) >= 0.5 for i in range(2)}
    momentum = bn_momentum_for(BN_SCHED, EPOCH)
    key = jax.random.key(12)

    def port(bn):
        model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg["model"])), device="cpu",
                                     seed=2)
        state = TrainState.create(model, ConfigDict(copy.deepcopy(cfg)), SPE)
        step = make_train_step(model, ConfigDict(copy.deepcopy(cfg)), device="cpu")
        count, perm, A, bvec, m = affine
        pipe = tf._pipeline_draws(key, cfg["dataset"]["train"]["others"]["npoints"])
        draws = StepDraws(
            PipelineDraws(_t(pipe[0]).long(), _t(pipe[1]).long()),
            SupervisedDraws(_t(mask), [AffineR3Draws(count, perm.tolist(), _t(A), _t(bvec),
                                                     _t(m)), None], _t(dp_enc), None,
                            dropout=[_t(drop["dp0"]), _t(drop["dp1"])]))
        init = to_flax(model.state_dict())
        out = step(state, _t(raw), draws=draws, labels=_t(labels), bn_momentum=bn)
        p, s = to_flax(model.state_dict())
        return init, float(out["loss_xyz"]), _flatten(p), _flatten(s)

    init, tl, tp, ts = port(momentum)
    ts_plain = port(None)[3]

    count, perm, A, bvec, m = affine

    def corrupt(key_, neigh, center, types, fix_translate_bug=False):
        return jcp._apply_affine_r3((jnp.int32(count), jnp.asarray(perm), jnp.asarray(A),
                                     jnp.asarray(bvec), jnp.asarray(m)), neigh, center)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            return jnp.where(jnp.asarray(drop[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    config = JConfigDict(copy.deepcopy(cfg))
    jmodel = j_build(config["model"])
    tx, _ = j_build_optimizer(config, init[0], steps_per_epoch=SPE)
    state = JTrainState.create(jmodel.apply, init[0], init[1], tx)
    with pytest.MonkeyPatch.context() as mp, fnn.intercept_methods(intercept):
        mp.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
        mp.setattr(jtr, "corrupt_patches", corrupt)
        mp.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                   if det or max(dpr) == 0.0 else jnp.asarray(dp_enc))
        step = j_make_train_step(jmodel, config, mesh=None)
        state, metrics = step(state, jnp.asarray(raw), jnp.asarray(labels, jnp.int32), key,
                              jnp.float32(0.0), jnp.float32(momentum))
    state = jax.device_get(state)
    flat = lambda tree: _flatten(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    return (flat(init[0]), float(metrics["loss_xyz"]), flat(state.params),
            flat(state.batch_stats), tl, tp, ts, ts_plain)


# biases followed by a BatchNorm: their true gradient is zero, so Adam's
# first step moves them by up to lr either way in each package. The
# encoder's final norm's bias is one too: it shifts every token of every
# cloud alike, so the pooled feature's fc0 output by a constant a channel,
# which the head's bn0 takes out
_NULL_GRAD = tf._NULL_GRAD + ("MAE_encoder/norm/bias", "cls_head_finetune/fc0/bias",
                              "cls_head_finetune/fc1/bias")


def test_supervised_step_matches_jax():
    """The NLL of the labels within 1e-5 relative (``loss_normal`` is 0);
    every parameter after the AdamW step as the flagship's f32 step holds
    them, the BatchNorm-fed biases within Adam's bound."""
    init, jl, jp, _, tl, tp, _, _ = _supervised_step()
    assert jl > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tp) == set(jp)
    assert any(not np.array_equal(init[k], jp[k]) for k in jp)
    for k in sorted(set(jp) - set(_NULL_GRAD)):
        np.testing.assert_allclose(tp[k], jp[k], rtol=2e-3, atol=5e-4, err_msg=k)
    for k in _NULL_GRAD:
        for got in (jp[k], tp[k]):
            assert np.abs(got - init[k]).max() <= tf._LR * (1 + 1e-4), k


def test_bnmscheduler_reblend_matches_jax():
    """The running statistics after a step at the scheduled momentum
    (epoch 2: max(0.1 * 0.5 ** 1, 0.01) = 0.05) within 1e-5 relative of
    JAX's re-blend; without the scheduler they move twice as far."""
    assert bn_momentum_for(BN_SCHED, EPOCH) == 0.05
    assert bn_momentum_for(BN_SCHED, 40) == 0.01
    _, _, _, js, _, _, ts, ts_plain = _supervised_step()
    assert set(ts) == set(js) and len(js) == 8
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in js:
        init = 1.0 if k.endswith("var") else 0.0
        np.testing.assert_allclose(ts_plain[k] - init, 2 * (ts[k] - init), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


SCHEDULES = [("LambdaLR", {"lr_decay": 0.9, "decay_step": 2, "lowest_decay": 0.3}),
             ("StepLR", {"step_size": 3, "gamma": 0.5}),
             ("function", {}),
             ("CosLR", {"epochs": 12, "warmup_epochs": 2, "min_lr": 1e-5})]


def _opt_config(stype, kwargs, spu=2):
    return {"optimizer": {"type": "AdamW", "kwargs": {"lr": 2e-3, "weight_decay": 0.05}},
            "scheduler": {"type": stype, "kwargs": kwargs}, "max_epoch": 12,
            "step_per_update": spu}


def _small_model():
    cfg = _tiny_config()["model"]
    cfg["NAME"] = "PointCAE_transformer_fc_center"
    cfg["transformer_config"].update(trans_dim=16, encoder_dims=16, depth=1)
    return build_model_from_cfg(ConfigDict(cfg), device="cpu", seed=1)


@pytest.mark.parametrize("stype,kwargs", SCHEDULES, ids=[s for s, _ in SCHEDULES])
def test_schedule_matches_jax(stype, kwargs):
    """At 7 mini-batches an epoch and ``step_per_update: 2``: the rate a
    mini-batch (logged) and the rate an update (3.5 updates an epoch) at
    steps 0-199, within 1e-6 relative of the JAX package's; ``TrainState``
    updates by the second."""
    config = _opt_config(stype, kwargs)
    state = TrainState.create(_small_model(), ConfigDict(config), 7)
    steps = np.arange(200)
    for spe, sched in ((7, state.schedule), (3.5, state.update_schedule)):
        want = np.asarray(j_lr(config, spe)(steps))
        got = np.array([sched(int(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{stype} {spe}")
        assert np.array_equal(got, [make_lr_schedule(config, spe)(int(s)) for s in steps])
    if stype != "function":
        assert len(set(np.round(got, 12))) > 2


def test_step_per_update_matches_multisteps():
    """Four mini-steps at ``step_per_update: 2`` with a clip of 0.5 (the
    windows' mean gradients have norms near 10) from the same gradients:
    the parameters after each mini-step within 1e-6 of optax's
    ``MultiSteps``; none moves on the first and third."""
    config = _opt_config("CosLR", {"epochs": 12, "warmup_epochs": 1}, spu=2)
    model = _small_model()
    state = TrainState.create(model, ConfigDict(config), 3, grad_norm_clip=0.5)
    params = to_flax(model.state_dict())[0]
    tx, _ = j_build_optimizer(JConfigDict(config), params, steps_per_epoch=3,
                              grad_norm_clip=0.5)
    opt = tx.init(params)
    g = torch.Generator().manual_seed(9)
    update = jax.jit(lambda gr, o, p: tx.update(gr, o, p))
    for i in range(4):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        grads = {n: 0.05 * torch.randn(p.shape, generator=g) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        state.apply_gradients()
        upd, opt = update(to_flax(grads)[0], opt, params)
        params = optax.apply_updates(params, upd)
        want = _flatten(jax.tree_util.tree_map(np.asarray, params))
        got = _flatten(to_flax(model.state_dict())[0])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"mini-step {i} {k}")
        moved = any(not torch.equal(before[n], p) for n, p in model.named_parameters())
        assert moved == (i % 2 == 1) and state.step == (i + 1) // 2, i
