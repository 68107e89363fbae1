"""One whole flagship pretrain step of the PyTorch port against the JAX
package, at ``_tiny_config`` shapes with ``fold_impl`` in {``xla``, ``auto``}
(on the CPU both packages take their unfused paths for ``auto``, which pins
that the port's kernel gates do not open off the card): the same raw batch,
the same initial weights (carried through ``from_flax``) and the same
random draws (resample indices recomputed from the JAX step's keys;
patch mask, affine_r3 parameters and stochastic-depth masks fed to the JAX
model through monkeypatch). Compared: both losses, every updated
parameter and the BatchNorm running statistics."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_tpu.data import corruptions_patch as jcp
from point_dae_tpu.engine.pretrain import (init_model as j_init_model,
                                           make_train_step as j_make_train_step)
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.data.corruptions_patch import AffineR3Draws
from point_dae_torch.engine.pretrain import (PipelineDraws, StepDraws,
                                             make_train_step)
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, NRAW, STEPS_PER_EPOCH = 4, 256, 10


def _config(bf16: bool, fold_impl: str):
    cfg = _tiny_config()
    tc = cfg["model"]["transformer_config"]
    if fold_impl != "auto":            # 'auto' is the default: no key at all
        tc["fold_impl"] = fold_impl
    if not bf16:
        del tc["dtype"]
    return cfg


def _draws(cfg, rng):
    """numpy draws: mask (B, G) with 10 of 16 patches masked (so both the
    visible and the masked packing have padding slots), the affine_r3 set
    with three families, and the encoder's keep masks with drops in the
    block whose rate is nonzero."""
    G = cfg["model"]["num_group"]
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:10]] = True
    count, _, A, bvec, m = jax.device_get(
        jcp._sample_affine_r3(jax.random.key(5), B, False))
    affine = (3, np.array([2, 4, 0, 1, 3], np.int32), np.asarray(A),
              np.asarray(bvec), np.asarray(m))
    depth = cfg["model"]["transformer_config"]["depth"]
    dp_enc = rng.uniform(size=(depth, 2, B)) >= 0.3
    dp_enc[-1, :, 0] = False
    dp_enc[-1, :, 1] = True
    return mask, affine, dp_enc


def _run_jax(cfg, raw, key, mask, affine, dp_enc, monkeypatch):
    monkeypatch.setattr(jtr, "sample_patch_mask",
                        lambda *a, **k: jnp.asarray(mask))
    count, perm, A, bvec, m = affine

    def corrupt(key_, neigh, center, types, fix_translate_bug=False):
        assert tuple(types) == ("affine_r3", "Drop-Patch")
        return jcp._apply_affine_r3(
            (jnp.int32(count), jnp.asarray(perm), jnp.asarray(A),
             jnp.asarray(bvec), jnp.asarray(m)), neigh, center)

    monkeypatch.setattr(jtr, "corrupt_patches", corrupt)

    def dp_masks(mod, dpr, batch, deterministic):
        if deterministic or max(dpr) == 0.0:
            return None
        assert len(dpr) == dp_enc.shape[0]
        return jnp.asarray(dp_enc)

    monkeypatch.setattr(jlayers, "_stack_dp_masks", dp_masks)

    config = JConfigDict(copy.deepcopy(cfg))
    model = j_build(config["model"])
    params, stats = j_init_model(model, config, jnp.asarray(raw))
    tx, _ = j_build_optimizer(config, params, steps_per_epoch=STEPS_PER_EPOCH)
    state = JTrainState.create(model.apply, params, stats, tx)
    init = jax.device_get((state.params, state.batch_stats))
    step = j_make_train_step(model, config, mesh=None)
    state, metrics = step(state, jnp.asarray(raw), key, jnp.float32(0.0))
    return init, jax.device_get((state.params, state.batch_stats, metrics))


def _pipeline_draws(key, npoints):
    """The resample indices ``device_pipeline`` draws from the step key."""
    k_pipe = jax.random.split(key, 5)[0]
    _, _, k_s1, k_s2 = jax.random.split(k_pipe, 4)
    clean = jax.random.randint(k_s1, (B, npoints), 0, NRAW)
    corrupted = jax.random.randint(k_s2, (B, npoints), 0, NRAW)
    return np.asarray(corrupted), np.asarray(clean)


def _run_torch(cfg, raw, init, pipe, mask, affine, dp_enc):
    config = ConfigDict(copy.deepcopy(cfg))
    model = build_model_from_cfg(config["model"], device="cpu")
    model.load_state_dict(from_flax(*init))
    state = TrainState.create(model, config, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(model, config, device="cpu")
    count, perm, A, bvec, m = affine
    draws = StepDraws(
        PipelineDraws(torch.tensor(pipe[0]).long(), torch.tensor(pipe[1]).long()),
        ModelDraws(torch.from_numpy(mask),
                   [AffineR3Draws(count, perm.tolist(), torch.tensor(A),
                                  torch.tensor(bvec), torch.tensor(m)), None],
                   torch.from_numpy(dp_enc), None))
    metrics = step(state, torch.from_numpy(raw), draws=draws)
    params, stats = to_flax(model.state_dict())
    return params, stats, {k: float(v) for k, v in metrics.items()}


def _compare(bf16, fold_impl, monkeypatch):
    cfg = _config(bf16, fold_impl)
    rng = np.random.default_rng(7)
    raw = rng.normal(size=(B, NRAW, 6)).astype(np.float32)
    mask, affine, dp_enc = _draws(cfg, rng)
    key = jax.random.key(11)
    init, (jp, js, jm) = _run_jax(cfg, raw, key, mask, affine, dp_enc, monkeypatch)
    npoints = cfg["dataset"]["train"]["others"]["npoints"]
    tp, ts, tm = _run_torch(cfg, raw, init, _pipeline_draws(key, npoints),
                            mask, affine, dp_enc)
    jp, js = _flatten(jax.tree_util.tree_map(np.asarray, jp)), _flatten(
        jax.tree_util.tree_map(np.asarray, js))
    tp, ts = _flatten(tp), _flatten(ts)
    assert set(jp) == set(tp) and set(js) == set(ts)
    moved = _flatten(jax.tree_util.tree_map(np.asarray, init[0]))
    assert any(not np.array_equal(moved[k], jp[k]) for k in jp)
    return jm, tm, jp, tp, js, ts, moved


# Biases followed by a BatchNorm (conv2 through the max-pool and conv3's
# split product): BN removes any per-channel shift, so their true gradient
# is exactly zero and what each framework computes is rounding noise, which
# Adam's first step g / (|g| + eps) turns into updates of up to lr in either
# direction. For them the step is held to Adam's bound, |update| <= lr.
_NULL_GRAD = ("MAE_encoder/encoder/conv1/bias", "MAE_encoder/encoder/conv2/bias",
              "MAE_encoder/encoder/conv3/bias")
_LR = 1e-3


def _check_null_grad_params(init, jp, tp):
    for k in _NULL_GRAD:
        for got in (jp[k], tp[k]):
            assert np.abs(got - init[k]).max() <= _LR * (1 + 1e-4), k


def _check_stats(js, ts):
    for k in sorted(js):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"batch_stats {k}")


@pytest.mark.parametrize("fold_impl", ["xla", "auto"])
def test_train_step_f32_matches_jax(monkeypatch, fold_impl):
    jm, tm, jp, tp, js, ts, init = _compare(False, fold_impl, monkeypatch)
    for k in ("loss_xyz", "loss_normal"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    for k in sorted(set(jp) - set(_NULL_GRAD)):
        np.testing.assert_allclose(tp[k], jp[k], rtol=2e-3, atol=5e-4,
                                   err_msg=f"param {k}")
    _check_null_grad_params(init, jp, tp)
    _check_stats(js, ts)


@pytest.mark.parametrize("fold_impl", ["xla", "auto"])
def test_train_step_bf16_matches_jax(monkeypatch, fold_impl):
    """bf16 compute rounds at other places in the two frameworks (flax's
    Dense rounds its product and bias add separately, torch's CPU bf16
    kernels keep f32 inside each op). Losses agree to 1e-3. A parameter
    whose gradient is within bf16 noise of zero can take Adam's first step
    (about +-lr) in opposite directions, so each tensor must have at least
    95% of its elements within the f32 tolerance and every element within
    two Adam steps (2 lr) of the JAX value."""
    jm, tm, jp, tp, js, ts, init = _compare(True, fold_impl, monkeypatch)
    for k in ("loss_xyz", "loss_normal"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-3, err_msg=k)
    for k in sorted(set(jp) - set(_NULL_GRAD)):
        close = np.isclose(tp[k], jp[k], rtol=2e-3, atol=5e-4)
        assert close.mean() >= 0.95, (k, float(close.mean()))
        assert np.abs(tp[k] - jp[k]).max() <= 2 * _LR * (1 + 1e-4), k
    _check_null_grad_params(init, jp, tp)
    _check_stats(js, ts)
