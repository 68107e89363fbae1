"""The MaskSurf family of the port against the JAX package on the CPU, at a
tiny width (trans_dim 64, depth 2, decoder depth 1, G 16 x S 8 of 128
points, B 2; the token_dis tokenizer 64 tokens): the same weights (the
port's initial ones, carried to JAX through ``to_flax``), the same clouds with unit normals (7
channels, a positive curvature last, for the curve variants), the same
patch mask and stochastic-depth masks (fed to the JAX model through
monkeypatch). Compared, for each registered class and the ``MaskSurf_v2``
alias: both losses and the gradient of their sum for every parameter;
then one AdamW step of every parameter, including those that no loss
reaches; the frozen tokenizer of token_dis stays as it was; the flagship
with ``loss: cdl1``; the weight bridge both ways."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_tpu.engine.pretrain import init_model as j_init_model
from point_dae_tpu.engine.train_state import build_optimizer as j_build_optimizer
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, G, S, DEPTH, DEC_DEPTH = 2, 128, 16, 8, 2, 1
MASKED = 9                      # floor(0.6 * 16)
LR = 1e-3
NAMES = ["MaskSurf", "MaskSurf_estimated_position", "MaskSurf_v2",
         "MaskSurf_v2_local_global_point", "MaskSurf_v2_local_point_only",
         "MaskSurf_v2_local_point_normal", "MaskSurf_v2_local_point_position",
         "MaskSurf_v2_local_point_normal_position",
         "MaskSurf_v2_local_point_normal_position_curve", "MaskSurf_v2_local_point_curve",
         "MaskSurf_v2_token_dis"]
CASES = [(n, False) for n in NAMES] + [("MaskSurf_v2_token_dis", True)]
STEPPED = ("MaskSurf_v2_local_point_only", "MaskSurf_v2_token_dis")   # the AdamW step's cases


def _config(name, all_patch=False):
    model = {"NAME": name, "corrupt_type": ["clean"], "all_patch": str(all_patch),
             "group_size": S, "num_group": G, "loss": "cdl2normal",
             "position_weight": 0.7, "weight_dis_vs_normal": 3.0,
             "dvae_config": {"num_tokens": 64, "encoder_dims": 32, "tokens_dims": 16,
                             "decoder_dims": 16},
             "transformer_config": {
                 "rand_ratio": "False", "mask_ratio": 0.6, "mask_type": "rand",
                 "trans_dim": 64, "encoder_dims": 64, "depth": DEPTH, "drop_path_rate": 0.1,
                 "num_heads": 4, "decoder_depth": DEC_DEPTH, "decoder_num_heads": 4}}
    return {
        "optimizer": {"type": "AdamW", "part": "all",
                      "kwargs": {"lr": LR, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300}},
        "dataset": {"train": {"others": {"npoints": N, "aug_type": ["norm"],
                                         "corrupt_type": ["clean"]}}},
        "model": model, "npoints": N, "total_bs": B, "loss_type": "xyznormal"}


def _clouds(name, rng):
    """xyz and unit normals; the curve variants also a curvature >= 0."""
    xyz = rng.normal(size=(B, N, 3))
    nrm = rng.normal(size=(B, N, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    cols = [xyz, nrm] + ([np.abs(rng.normal(size=(B, N, 1)))] if "curve" in name else [])
    return np.concatenate(cols, -1).astype(np.float32)


def _draws(rng):
    """MASKED of G patches a cloud; the encoder's keep masks with a drop in
    its second block (the first block's rate is 0, the decoder's one
    block's too)."""
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:MASKED]] = True
    dp = np.ones((DEPTH, 2, B), bool)
    dp[1, 0, 1] = False
    return mask, dp


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port_model(cfg):
    """The port's model at its initial weights (seed 0), with the
    tokenizer's BatchNorm statistics set away from (0, 1)."""
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg))["model"], device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.startswith("dvae_teacher.") and name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape)))
            elif name.startswith("dvae_teacher.") and name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, buf.shape)))
    return model


def _jax_grads(cfg, params, stats, clean, draws, with_step=False):
    """(losses, flat gradients of their sum, flat parameters after one
    optax AdamW step or None) of the JAX model at the given weights and
    draws."""
    mask, dp = draws
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
        mp.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                   if det or max(dpr) == 0.0 else jnp.asarray(dp))
        config = JConfigDict(copy.deepcopy(cfg))
        model = j_build(config["model"])
        keys = {n: jax.random.key(i) for i, n in enumerate(("corrupt", "mask", "droppath",
                                                            "dropout"))}

        def loss_fn(p, x):
            (l1, l2), _ = model.apply({"params": p, "batch_stats": stats}, x, x, train=True,
                                      rngs=keys, mutable=["batch_stats"])
            return l1 + l2, (l1, l2)

        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, jnp.asarray(clean))
    after = None
    if with_step:
        tx, _ = j_build_optimizer(config, params, steps_per_epoch=10)
        step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
        after = _flatten(_tree(step(grads, params)))
    return [float(v) for v in losses], _flatten(_tree(grads)), after


@functools.lru_cache(maxsize=None)
def _case(name, all_patch=False):
    """Both packages on one case: (port model after its backward, port
    losses, JAX losses, JAX gradients, JAX parameters after one AdamW step,
    the initial flat parameters). The ``MaskSurf_v2`` alias reuses the JAX
    run of its class: the same function of the same weights."""
    cfg = _config(name, all_patch)
    rng = np.random.default_rng(3)
    clean = _clouds(name, rng)
    draws = _draws(rng)
    model = _port_model(cfg)
    params, stats = to_flax(model.state_dict())
    if name == "MaskSurf_v2":
        jax_out = _case("MaskSurf_v2_local_global_point", False)[2:5]
    else:
        jax_out = _jax_grads(cfg, params, stats, clean, draws, with_step=name in STEPPED)
    mask, dp = draws
    model.train()
    t = torch.from_numpy(clean)
    l1, l2 = model(t, t, draws=ModelDraws(torch.from_numpy(mask), None,
                                          torch.from_numpy(dp), None))
    (l1 + l2).backward()
    return (model, [float(l1.detach()), float(l2.detach())]) + tuple(jax_out) + \
        (_flatten(params),)


def _check_grads(model, grads_j):
    """Each gradient within 1e-4 of its tensor's largest magnitude (f32
    sums in another order, through max-pools), or within 1e-6 of the
    model's largest gradient where the tensor's own is rounding noise (a
    bias followed by BatchNorm: zero but for rounding). A parameter that
    the port leaves without a gradient (the unused coarse_pred, the frozen
    tokenizer) has an all-zero one in JAX."""
    grads_t = _flatten(to_flax({n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None})[0])
    assert set(grads_t) <= set(grads_j)
    for k in set(grads_j) - set(grads_t):
        assert not np.any(grads_j[k]), k
    top = max(np.abs(g).max() for g in grads_j.values())
    for k in sorted(grads_t):
        g = grads_j[k]
        np.testing.assert_allclose(grads_t[k], g, rtol=0,
                                   atol=max(1e-4 * np.abs(g).max(), 1e-6 * top), err_msg=k)
    return set(grads_j) - set(grads_t), top


@pytest.mark.parametrize("name,all_patch", CASES,
                         ids=[n + ("-all_patch" if a else "") for n, a in CASES])
def test_masksurf_losses_and_grads_match_jax(name, all_patch):
    """Both losses within 1e-5 relative (1e-7 absolute where the JAX loss
    is exactly 0), every gradient as ``_check_grads`` says."""
    model, losses_t, losses_j, grads_j, _, _ = _case(name, all_patch)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5, atol=1e-7)
    assert losses_j[0] > 0
    dead, _ = _check_grads(model, grads_j)
    want = {"MaskSurf_v2_local_point_only", "MaskSurf_v2_local_point_normal",
            "MaskSurf_v2_local_point_position", "MaskSurf_v2_local_point_normal_position",
            "MaskSurf_v2_local_point_normal_position_curve", "MaskSurf_v2_local_point_curve"}
    prefix = "coarse_pred/" if name in want else \
        "dvae_teacher/" if name == "MaskSurf_v2_token_dis" else None
    assert all(prefix and k.startswith(prefix) for k in dead), sorted(dead)
    if prefix:
        assert dead == {k for k in grads_j if k.startswith(prefix)}


@pytest.mark.parametrize("name", STEPPED)
def test_masksurf_adamw_step_matches_jax(name):
    """One AdamW step (lr 1e-3, weight decay 0.05) of every parameter
    against optax's: within 2e-3 relative and 5e-4 absolute, the unused
    coarse_pred decayed as optax decays it; a parameter whose JAX
    gradient is rounding noise (below 1e-6 of the largest) moves at most
    Adam's bound lr, in either package, whichever way its noise points.
    The tokenizer of token_dis and its running statistics stay bit for
    bit."""
    model, _, _, grads_j, after_j, init = _case(name)
    _, top = _check_grads(model, grads_j)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, ConfigDict(copy.deepcopy(_config(name))),
                              steps_per_epoch=10)
    state.apply_gradients()
    after_t = _flatten(to_flax(model.state_dict())[0])
    assert set(after_t) == set(after_j)
    moved = 0
    for k in sorted(after_j):
        if k.startswith("dvae_teacher/"):
            assert np.array_equal(after_j[k], init[k]), k
            continue
        if np.abs(grads_j[k]).max() < 1e-6 * top and np.any(grads_j[k]):
            for got in (after_t[k], after_j[k]):
                assert np.abs(got - init[k]).max() <= LR * (1 + 1e-4), k
            continue
        np.testing.assert_allclose(after_t[k], after_j[k], rtol=2e-3, atol=5e-4, err_msg=k)
        moved += not np.array_equal(after_j[k], init[k])
    assert moved > 0
    if name == "MaskSurf_v2_local_point_only":
        k = "coarse_pred/dense0/kernel"
        assert not np.any(grads_j[k]) and not np.array_equal(after_t[k], init[k])
    sd = model.state_dict()
    frozen = [k for k in sd if k.startswith("dvae_teacher.")]
    assert bool(frozen) == (name == "MaskSurf_v2_token_dis")
    assert all(torch.equal(sd[k], before[k]) for k in frozen)


def test_flagship_with_cdl1_matches_jax():
    """The flagship with ``loss: cdl1`` (chamfer-L1 for both heads; the
    port refused it before): both losses within 1e-5 relative and the
    gradients as ``_check_grads`` says."""
    cfg = _tiny_config()                          # G 16 x S 8 of 128 points
    cfg["model"].update(loss="cdl1", corrupt_type=["Drop-Patch"])
    tc = cfg["model"]["transformer_config"]
    tc.pop("dtype")
    tc.update(rand_ratio="False", depth=DEPTH, decoder_depth=DEC_DEPTH)
    rng = np.random.default_rng(6)
    clean = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask, dp = _draws(rng)
    model = _port_model(cfg)
    params, stats = to_flax(model.state_dict())
    losses_j, grads_j, _ = _jax_grads(cfg, params, stats, clean, (mask, dp))
    model.train()
    t = torch.from_numpy(clean)
    l1, l2 = model(t, t, draws=ModelDraws(torch.from_numpy(mask), [None, None],
                                          torch.from_numpy(dp), None))
    (l1 + l2).backward()
    np.testing.assert_allclose([float(l1.detach()), float(l2.detach())], losses_j, rtol=1e-5)
    dead, _ = _check_grads(model, grads_j)
    assert not dead


@pytest.mark.parametrize("name", NAMES)
def test_masksurf_weights_carry_across_both_ways(name):
    """A state dict -> flax tree -> state dict is the identity, and the tree
    has the JAX model's paths and shapes (token_dis: the tokenizer's
    encoder, dgcnn_1 and codebook only, as in JAX)."""
    cfg = _config(name)
    jmodel = j_build(JConfigDict(copy.deepcopy(cfg))["model"])
    c = 7 if "curve" in name else 6
    shapes = jax.eval_shape(lambda: j_init_model(jmodel, JConfigDict(copy.deepcopy(cfg)),
                                                 jnp.zeros((B, N, c), jnp.float32)))
    shapes = jax.tree_util.tree_map(lambda x: np.empty(x.shape, np.float32), shapes)
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg))["model"], device="cpu")
    sd = model.state_dict()
    p, s = to_flax(sd)
    flat = lambda tree: {k: np.shape(v) for k, v in _flatten(tree).items()}
    assert flat(p) == flat(shapes[0]) and flat(s) == flat(shapes[1])
    back = from_flax(p, s)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
