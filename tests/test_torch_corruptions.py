"""Every whole-cloud corruption family and augmentation of the PyTorch port
against the JAX package on the CPU: ``corrupt_batch`` against
``vmap(corrupt_cloud)`` and ``augment_batch`` against
``vmap(augment_cloud)`` on the same draws (replayed from the JAX keys,
``tests/_jax_draws.py``), and one DGCNN pretrain step with
``['random_add', 'affine_r3']``.

Tolerances: validity masks exactly; points within 1e-5 absolute and
relative (a 3 x 3 product chain, the ball's u^(1/3), cos and sin, and the
masked mean's sum, each an ulp or two apart between torch and XLA; read:
at most 6e-6)."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_draws as jd
from point_dae_tpu.data import corruptions as jc
from point_dae_tpu.engine.pretrain import (init_model as j_init_model,
                                           make_train_step as j_make_train_step)
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.data import corruptions as tc
from point_dae_torch.engine.pretrain import StepDraws, make_train_step
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

SINGLE_AFFINES = tuple(jc._AFFINE_FNS)     # every name, partial widths and levels included
BATCH, N = 8, 64

# id -> corrupt_type; every case at (BATCH, N), all traced in one jit
CASES = {
    **{t: (t,) for t in ("affine_r3", "affine_r5", "affine_r3_v2", "affine_r5_v2")},
    **{t: (t,) for t in SINGLE_AFFINES},
    "jitter": ("jitter", "jitter_p01", "jitter_p03", "jitter_p05", "jitter_p1"),
    "dropout_local_then_scale": ("dropout_local", "scale"),
    "dropout_local_cXdY_scale_single": ("dropout_local_c1d1", "dropout_local_c8d9",
                                        "scale_single"),
    "add_global": ("add_global", "jitter"),
    "add_local": ("add_local",),
    # the second c1d9 leaves 1 valid point a cloud: add_local's anchors reach
    # past the valid rows (masked rows tie at -1 and go by index)
    "add_local_few_valid": ("dropout_local_c1d9", "dropout_local_c1d9", "add_local"),
    "random_add": ("random_add", "affine_r3"),
    "nonuniform_density": ("nonuniform_density", "jitter"),
    "repeated": ("affine_r3", "add_global", "affine_r3", "add_global"),
    "no_ops": ("clean", "dropout_global", "dropout_patch_pointmae", "dropout_global_p3"),
}


@functools.lru_cache(maxsize=None)
def _jax_cases():
    """Per case: (points, JAX points, JAX mask, the replayed draws)."""
    pts = np.random.default_rng(0).normal(size=(BATCH, N, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), BATCH)

    def one(k, p):
        return {c: (jc.corrupt_cloud(k, p, t), jd.cloud_draws(k, N, t))
                for c, t in CASES.items()}

    out = jax.device_get(jax.jit(jax.vmap(one))(keys, pts))
    return {c: (pts, want, mask, jd.to_cloud_draws(CASES[c], *draws))
            for c, ((want, mask), draws) in out.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_corrupt_batch_matches_jax(case):
    types = CASES[case]
    pts, want, want_mask, draws = _jax_cases()[case]
    got, mask = tc.corrupt_batch(torch.from_numpy(pts), types, draws=draws)
    assert got.shape == want.shape == (BATCH, tc.corruption_capacity(N, types), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if want_mask is None:
        assert mask is None
    else:
        np.testing.assert_array_equal(mask.numpy(), want_mask)
    if case == "no_ops":
        np.testing.assert_array_equal(got.numpy(), pts)
        return
    if case == "add_local_few_valid":
        assert (want_mask[:, :N].sum(1) < 7).all()
    elif got.shape[1] > N:                                         # points were added
        assert want_mask[:, N:].any()
    else:                                                          # or moved
        assert np.abs(got.numpy() - pts).max() > 1e-3
    if case == "random_add":
        assert set(draws.ops[0].coin.tolist()) == {False, True}    # both branches


def test_own_draws_run_every_family():
    """Without draws each family samples its own from the generator: the
    shapes, the masks' rules and the capacity hold."""
    pts = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 96, 3)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    names = (tuple(tc._COMPOSITES) + SINGLE_AFFINES + ("scale", "scale_single", "jitter")
             + tuple(tc._JITTER_P))
    out, mask = tc.corrupt_batch(pts, names, generator=g)
    assert out.shape == (3, 96, 3) and mask is None and torch.isfinite(out).all()
    types = ("dropout_local_c3d5", "random_add", "add_global", "add_local",
             "nonuniform_density", "dropout_local")
    out, mask = tc.corrupt_batch(pts, types, generator=g)
    assert out.shape == (3, 96 + 3 * 48, 3) == tuple(mask.shape) + (3,)
    assert torch.isfinite(out).all() and (mask.sum(1) > 0).all()
    for bad in ("rotate_x", "jitter_p2"):
        with pytest.raises(NotImplementedError, match=bad):
            tc.corrupt_batch(pts, ("clean", bad), generator=g)
    with pytest.raises(NotImplementedError, match="rotate_x"):
        jax.eval_shape(lambda p: jc.corrupt_cloud(jax.random.key(0), p, ("rotate_x",)),
                       jnp.zeros((8, 3)))


AUGMENTS = ("norm", "translate", "scale", "rotate_z", "rotate", "clean")


def test_augment_batch_matches_jax():
    pts = np.random.default_rng(5).normal(size=(4, 64, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(8), 4)
    want = jax.jit(jax.vmap(lambda k, p: jc.augment_cloud(k, p, AUGMENTS)))(keys, pts)
    got = tc.augment_batch(torch.from_numpy(pts), AUGMENTS,
                           draws=jd.batch_augment_draws(keys, AUGMENTS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(1)
    own = tc.augment_batch(torch.from_numpy(pts), AUGMENTS, generator=g)
    assert own.shape == (4, 64, 3) and torch.isfinite(own).all()
    with pytest.raises(NotImplementedError, match="jitter"):
        tc.augment_batch(torch.from_numpy(pts), ("jitter",))


# ------------------------------------------------- one DGCNN step, random_add

TYPES = ("random_add", "affine_r3")
B, NRAW, NPOINTS, STEPS_PER_EPOCH = 4, 128, 64, 10


def _dgcnn_config():
    return {
        "optimizer": {"type": "AdamW", "part": "all",
                      "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
        "dataset": {"train": {"others": {"npoints": NPOINTS, "aug_type": ["norm"],
                                         "corrupt_type": list(TYPES)}}},
        "model": {"NAME": "Point_CAE_DGCNN_FCOnly", "corrupt_type": list(TYPES),
                  "loss": "cdl2", "edgeconv_impl": "fused"},
        "npoints": NPOINTS, "total_bs": B, "step_per_update": 1, "max_epoch": 300,
        "loss_type": "xyznormal_gradual"}


def _adam_gradients(opt_state):
    """The gradients of the JAX step, read from Adam's first moment after
    its first update (mu = (1 - b1) g, b1 0.9)."""
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return _flatten(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                           jax.device_get(adam.mu)))


# the layers behind the four kNN graphs and their maxima over neighbours
_EDGECONV = ("dgcnn_encoder/ec1/", "dgcnn_encoder/ec2/", "dgcnn_encoder/ec3/",
             "dgcnn_encoder/ec4/")


def test_dgcnn_random_add_step_matches_jax():
    """The pipeline grows each cloud to 1.5 NRAW rows and resamples from the
    valid ones. The loss to 1e-4. The gradients of both frameworks (the
    port's ``.grad``, JAX's from Adam's first moment), every element within
    rtol 2e-3 and a fraction of its tensor's largest gradient: 1e-3 after
    the last EdgeConv (read: at most 1.1e-4), 5e-2 in the four EdgeConvs,
    where a neighbour of the kNN or of the max over neighbours at a
    near-tie takes a channel's gradient to another point (read: at most
    2.1e-2, in ec4's kernel). Every updated parameter within the f32 step
    tolerance of ``test_torch_dgcnn.py`` (rtol 2e-3, atol 5e-4) except
    where Adam's first step, lr g / (|g| + 1e-8), meets a gradient near
    zero: the two gradients of such an element differ in sign or one lies
    in Adam's eps (below 1e-6 of the largest), the JAX one within 1e-2 of
    its tensor's largest (read: at most 1.9e-3), the gap within Adam's
    bound of 2 lr, and at most ceil(1e-5 size) of a tensor after the
    EdgeConvs, as in ``test_torch_dgcnn.py`` (read: 4 of conv5's 524288,
    7 of recfc dense2's 3.1 M), and 1e-3 of a tensor or 2 in the EdgeConvs
    (read: 7 of ec3's 16384 kernel elements, 2 of ec1's 64 BatchNorm
    biases, whose true gradient is zero where BN5 and the next EdgeConv's
    BatchNorm remove a channel's shift)."""
    cfg = _dgcnn_config()
    raw = np.random.default_rng(3).normal(size=(B, NRAW, 6)).astype(np.float32)
    key = jax.random.key(21)
    config = JConfigDict(copy.deepcopy(cfg))
    model = j_build(config["model"])
    params, stats = j_init_model(model, config, jnp.asarray(raw))
    tx, _ = j_build_optimizer(config, params, steps_per_epoch=STEPS_PER_EPOCH)
    state = JTrainState.create(model.apply, params, stats, tx)
    init = jax.device_get((state.params, state.batch_stats))
    state, jm = j_make_train_step(model, config, mesh=None)(
        state, jnp.asarray(raw), key, jnp.float32(0.5))
    jp = _flatten(jax.tree_util.tree_map(np.asarray, jax.device_get(state.params)))
    jg = _adam_gradients(state.opt_state)

    pipe = jd.pipeline_draws(key, raw, ("norm",), TYPES, NPOINTS)
    assert pipe.corrupt.ops[0].coin.any() and not pipe.corrupt.ops[0].coin.all()
    tconfig = ConfigDict(copy.deepcopy(cfg))
    tmodel = build_model_from_cfg(tconfig["model"], device="cpu")
    tmodel.load_state_dict(from_flax(*init), strict=True)
    tstate = TrainState.create(tmodel, tconfig, steps_per_epoch=STEPS_PER_EPOCH)
    tm = make_train_step(tmodel, tconfig, device="cpu")(
        tstate, torch.from_numpy(raw), gradual_weight=0.5, draws=StepDraws(pipe))
    tp = _flatten(to_flax(tmodel.state_dict())[0])
    tg = _flatten(to_flax({n: q.grad for n, q in tmodel.named_parameters()})[0])
    np.testing.assert_allclose(float(tm["loss_xyz"]), float(jm["loss_xyz"]), rtol=1e-4)
    assert set(tp) == set(jp) == set(tg) == set(jg)
    lr = cfg["optimizer"]["kwargs"]["lr"]
    for k in sorted(jp):
        edge = k.startswith(_EDGECONV)
        top = np.abs(jg[k]).max()
        np.testing.assert_allclose(tg[k], jg[k], rtol=2e-3, atol=(5e-2 if edge else 1e-3) * top,
                                   err_msg=f"gradient {k}")
        miss = ~np.isclose(tp[k], jp[k], rtol=2e-3, atol=5e-4)
        adam = (np.sign(tg[k]) != np.sign(jg[k])) | (np.minimum(
            np.abs(tg[k]), np.abs(jg[k])) <= 1e-6 * top)
        assert (adam[miss] & (np.abs(jg[k][miss]) <= 1e-2 * top)).all(), k
        cap = max(2, np.ceil(1e-3 * miss.size)) if edge else np.ceil(1e-5 * miss.size)
        assert miss.sum() <= cap, (k, int(miss.sum()))
        assert np.abs(tp[k] - jp[k]).max() <= 2 * lr * (1 + 1e-4), k
