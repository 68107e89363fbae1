"""The 3DETR-backbone DAE of the port, ``ball_query`` and
``sample_block_mask`` against the JAX package on the CPU, at a tiny width
(B 4, 256 points, G 16, S 8, dim 32, depth 2, 2 heads, one decoder
block): the same clouds (numpy seeds), the same weights (the port's
initial ones through ``to_flax``), the same draws (the patch mask through
monkeypatch; every encoder dropout mask, the attention's (T, T) ones
included, fed to flax through ``intercept_methods`` and a stand-in for
``flax.linen.attention.random``; the decoder's stochastic-depth masks
through monkeypatch).

The clouds are uniform in a cube of side 1, so that a ball of radius 0.2
holds about 8 points (some balls fewer than S, some more); each test
asserts that no squared distance of its ball queries lies within 1e-6 of
0.04, where the two packages' roundings could disagree on membership."""
import copy
import functools
import types

import flax.linen as fnn
import flax.linen.attention as fattention
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import detr3 as jdetr3
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models.transformer import sample_block_mask as j_block_mask
from point_dae_tpu.ops.geometry import ball_query as j_ball_query
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.detr3 import Detr3Draws, DetrLayerDraws
from point_dae_torch.models.transformer import sample_block_mask
from point_dae_torch.ops.geometry import (ball_query, furthest_point_sample, gather_points,
                                          pairwise_sqdist)
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, G, S, C, DEPTH, HEADS, FFN = 4, 256, 16, 8, 32, 2, 2, 128
V = G - G // 2                      # rand_ratio: the visible capacity
MODEL = {"NAME": "PointCAE_transformer_fc_global_fc_local_3detr",
         "corrupt_type": ["affine_r3", "Drop-Patch"], "all_patch": "False",
         "group_size": S, "num_group": G, "loss": "cdl2",
         "transformer_config": {"enc_arch": "3detr", "rand_ratio": "True", "mask_ratio": 0.6,
                                "mask_type": "rand", "trans_dim": C, "encoder_dims": C,
                                "depth": DEPTH, "drop_path_rate": 0.1, "num_heads": HEADS,
                                "decoder_depth": 1, "decoder_num_heads": HEADS}}
GRAD_KEYS = ("pre_encoder/mlp0/kernel", "pre_encoder/mlp2_bn/scale",
             "blocks/layer0/self_attn/query/kernel", "blocks/layer1/self_attn/value/bias",
             "blocks/layer0/self_attn/out/kernel", "blocks/layer1/linear1/kernel",
             "blocks/norm/scale", "coarse_pred/dense0/kernel", "increase_dim/kernel",
             "MAE_decoder/block0/attn/qkv/kernel", "decoder_pos_embed/fc1/kernel", "mask_token")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cloud(seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)


def _margin(xyz, centres=None):
    """The smallest |d - r^2| of the port's squared distances from
    ``centres`` (default: the cloud's G FPS centres, the model's queries)."""
    if centres is None:
        centres = gather_points(_t(xyz), furthest_point_sample(_t(xyz), G)).numpy()
    d = pairwise_sqdist(_t(centres), _t(xyz)).numpy()
    return float(np.abs(d - np.float32(0.04)).min())


# ------------------------------------------------------------------ parts

def test_ball_query_matches_jax():
    """Index order, the first in-range index repeated in the empty slots,
    zeros where no point is in range; exactly, including k > N's width."""
    xyz = _cloud(0)
    rng = np.random.default_rng(1)
    q = xyz[:, :12] + rng.normal(0, 0.05, size=(B, 12, 3)).astype(np.float32)
    q[:, -2:] += 3.0                                    # nothing in range
    assert _margin(xyz, q) > 1e-6
    for radius, k in ((0.35, 16), (0.2, N + 20), (0.2, 8)):
        want = np.asarray(jax.jit(j_ball_query, static_argnums=(0, 1))(radius, k, xyz, q))
        got = ball_query(radius, k, _t(xyz), _t(q)).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), (radius, k)
    cnt = (pairwise_sqdist(_t(q), _t(xyz)) < 0.04).sum(-1).numpy()
    assert (cnt == 0).any() and ((cnt > 0) & (cnt < 8)).any() and (cnt > 8).any()
    assert (got[cnt == 0] == 0).all()


@pytest.mark.parametrize("ratio", [0.6, 0.8])
def test_sample_block_mask_matches_jax(ratio):
    """The JAX key's seed patches fed to the port: the same masks, exactly,
    int(ratio G) a cloud."""
    centres = np.random.default_rng(2).normal(size=(B, G, 3)).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(j_block_mask(key, jnp.asarray(centres), ratio))
    seed = np.asarray(jax.random.randint(key, (B, 1, 1), 0, G)).reshape(B)
    got = sample_block_mask(_t(centres), ratio, _t(seed)).numpy()
    assert np.array_equal(got, want)
    assert (got.sum(1) == int(np.float32(ratio) * G)).all()
    assert got[np.arange(B), seed].all()


# ------------------------------------------------------------------ model

def _port(cfg=MODEL, seed=0):
    return build_model_from_cfg(ConfigDict(copy.deepcopy(cfg)), device="cpu", seed=seed)


def _draws(seed=6):
    """The patch mask (10 of 16 masked), each layer's dropout keep masks
    and the decoder's stochastic-depth masks, as numpy arrays."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:10]] = True
    keep = lambda *shape: rng.uniform(size=shape) >= 0.1  # noqa: E731
    layers = [{"attn": keep(V, V), "dropout1": keep(B, V, C), "dropout": keep(B, V, FFN),
               "dropout2": keep(B, V, C)} for _ in range(DEPTH)]
    dp = rng.uniform(size=(1, 2, B)) >= 0.2
    dp[0, 0, 1] = False
    return mask, layers, dp


def _jax_patches(mp, mask, layers, dp):
    mp.setattr(jdetr3, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
    mp.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
               if det or max(dpr) == 0.0 else jnp.asarray(dp))
    attn = iter([m["attn"] for m in layers])
    mp.setattr(fattention, "random", types.SimpleNamespace(
        bernoulli=lambda rng, p, shape: jnp.asarray(next(attn)).reshape(shape)))


def _dropout_interceptor(layers):
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            layer = int(mod.path[-2][len("layer"):])
            keep = jnp.asarray(layers[layer][mod.name])
            return jnp.where(keep, args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)
    return intercept


@functools.lru_cache(maxsize=None)
def _case():
    """(port model after its backward, port losses, JAX losses, JAX
    gradients, JAX batch statistics, the smallest |pre-activation| of the
    pre-encoder's ReLUs in the port)."""
    model = _port()
    params, stats = to_flax(model.state_dict(), num_heads=HEADS)
    clean = _cloud(3)
    corrupted = clean + np.random.default_rng(4).normal(0, 0.01, clean.shape).astype(np.float32)
    assert _margin(corrupted) > 1e-6 and _margin(clean) > 1e-6
    mask, layers, dp = _draws()
    jmodel = j_build(JConfigDict(copy.deepcopy(MODEL)))
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, mask, layers, dp)

        def loss_fn(p, cor, cln):
            (l1, l2), upd = jmodel.apply({"params": p, "batch_stats": stats}, cor, cln,
                                         train=True, mutable=["batch_stats"],
                                         rngs={k: jax.random.key(i) for i, k in
                                               enumerate(("mask", "dropout", "droppath"))})
            return l1 + l2, ((l1, l2), upd["batch_stats"])

        with fnn.intercept_methods(_dropout_interceptor(layers)):
            (_, (jl, jstats)), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                params, corrupted, clean)
    gates = []
    for layer in model.pre_encoder.mlp_module:
        layer.bn.bn.register_forward_hook(
            lambda m, a, o: gates.append(float(o.detach().abs().min())))
    model.train()
    draws = Detr3Draws(_t(mask), None, None, _t(dp), None,
                       [DetrLayerDraws(_t(m["attn"]), _t(m["dropout1"]), _t(m["dropout"]),
                                       _t(m["dropout2"])) for m in layers])
    l1, l2 = model(_t(corrupted), _t(clean), draws=draws)
    (l1 + l2).backward()
    return (model, [float(l1), float(l2)], [float(v) for v in jl],
            _flatten(jax.tree_util.tree_map(np.asarray, gj)),
            _flatten(jax.tree_util.tree_map(np.asarray, jstats)), min(gates))


def test_3detr_losses_and_gradients_match_jax():
    """Both losses within 1e-4 relative; the gradients of GRAD_KEYS (the
    pre-encoder, both attention forms, the FFN, the heads, the decoder,
    the mask token) within 1e-3 of their largest; the pre-encoder's
    BatchNorm statistics after the step within 1e-5 relative. The clouds
    keep every pre-encoder ReLU gate 1e-5 away from its tie."""
    model, got, want, gj, jstats, gate = _case()
    assert gate > 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[0] > 0 and want[1] > 0
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    gt = _flatten(to_flax(grads, num_heads=HEADS)[0])
    for k in GRAD_KEYS:
        assert np.abs(gj[k]).max() > 0, k
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=1e-3 * np.abs(gj[k]).max(),
                                   err_msg=k)
    ts = _flatten(to_flax(model.state_dict(), num_heads=HEADS)[1])
    assert set(ts) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(ts[k], jstats[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_3detr_dropouts_move_the_loss():
    """The same forward without the encoder's dropouts (all kept) differs:
    the masks reach the encoder."""
    model, got, *_ = _case()
    mask, layers, dp = _draws()
    ones = Detr3Draws(_t(mask), None, None, _t(dp), None,
                      [DetrLayerDraws(*(torch.ones(m[k].shape, dtype=torch.bool)
                                        for k in ("attn", "dropout1", "dropout", "dropout2")))
                       for m in layers])
    clean = _cloud(3)
    corrupted = clean + np.random.default_rng(4).normal(0, 0.01, clean.shape).astype(np.float32)
    with torch.no_grad():
        l1, _ = copy.deepcopy(model)(_t(corrupted), _t(clean), draws=ones)
    assert abs(float(l1) - got[0]) > 1e-6


def test_3detr_encode_matches_jax():
    """The SVM probe's feature in eval mode (BatchNorm statistics moved off
    their init values): within 1e-4 relative."""
    model = _port()
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(_t(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif n.endswith("running_mean"):
                b.copy_(_t(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    params, stats = to_flax(model.state_dict(), num_heads=HEADS)
    pts = _cloud(7)
    assert _margin(pts) > 1e-6
    jmodel = j_build(JConfigDict(copy.deepcopy(MODEL)))
    want = jax.jit(lambda p: jmodel.apply({"params": params, "batch_stats": stats}, p,
                                          method=jmodel.encode))(pts)
    with torch.no_grad():
        got = model.eval().encode(_t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["PointCAE_transformer_fc_global_fc_local_3detr",
                                  "PointCAE_transformer_fc_global_fc_local_3detr_encodernope"])
def test_3detr_weights_carry_across_both_ways(name):
    """``to_flax`` gives the JAX model's paths and shapes, the attention's
    3-D kernels and 2-D biases included; ``from_flax`` inverts it bit for
    bit and loads strictly."""
    cfg = dict(copy.deepcopy(MODEL), NAME=name)
    jmodel = j_build(JConfigDict(cfg))
    x = jnp.zeros((B, N, 3), jnp.float32)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "mask", "dropout",
                                                        "droppath"))}
    shapes = jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32),
                                    jax.eval_shape(lambda: jmodel.init(rngs, x, x, train=False)))
    model = _port(cfg)
    sd = model.state_dict()
    p, s = to_flax(sd, num_heads=HEADS)
    flat = lambda tree: {k: tuple(np.shape(v)) for k, v in _flatten(tree).items()}  # noqa: E731
    assert flat(p) == {k: tuple(v.shape) for k, v in _flatten(shapes["params"]).items()}
    assert flat(s) == {k: tuple(v.shape) for k, v in _flatten(shapes["batch_stats"]).items()}
    assert flat(p)["blocks/layer0/self_attn/query/kernel"] == (C, HEADS, C // HEADS)
    assert flat(p)["blocks/layer0/self_attn/out/kernel"] == (HEADS, C // HEADS, C)
    back = from_flax(p, s)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back, strict=True)
    with pytest.raises(ValueError):
        to_flax(sd)
