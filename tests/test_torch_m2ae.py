"""The Point-M2AE family of the port against the JAX package on the CPU, at a
tiny width (256 points, num_groups 32/16/8, group_sizes 8/4/4, dims
16/32/48, one block a stage, 2 heads, B 4): the same clouds (numpy seeds),
the same weights (the port's initial ones, carried to JAX through
``to_flax``), the same draws (the coarsest mask, each stage's
stochastic-depth keep masks and the head's dropout masks fed to the JAX
model through monkeypatch and ``intercept_methods``; the list corruption's
draws replayed from a fixed key). Compared: ``pyramid_group``,
``backprop_mask``, ``TokenEmbed`` at both width rules, ``HEncoder``
(masked and ``noaug``), ``TokenProp``, ``corrupt_patches_multi``; each
registered class's losses or logits within 1e-4 relative and, for the two
pretrain families and the fine-tune head, the gradients of a few
parameters within 1e-3 of their largest; the weight bridge both ways."""
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from point_dae_tpu.data import corruptions_patch as jcp
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import m2ae as jm2ae
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from _jax_draws import patch_draws
from point_dae_torch.data.corruptions_patch import corrupt_patches_multi
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models import m2ae as tm2ae
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.models.layers import PatchEncoder
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N = 4, 256
GROUPS, SIZES, DIMS = [32, 16, 8], [8, 4, 4], [16, 32, 48]
MASKED = 6                                   # floor(0.8 * 8)
CLOUD_SEED = 5          # the pretrain cases' clouds: no coarse-head ReLU gate near its tie
CORRUPT = ["affine_r3", "rotate", "Drop-Patch"]
MODEL = {"group_sizes": SIZES, "num_groups": GROUPS, "encoder_depths": [1, 1, 1],
         "encoder_dims": DIMS, "decoder_depths": [1, 1], "decoder_dims": [48, 32],
         "decoder_up_blocks": [1, 1], "drop_path_rate": 0.1, "num_heads": 2,
         "mask_ratio": 0.8, "local_radius": [0.32, 0.64, 1.28],
         "corrupt_type": CORRUPT, "cls_dim": 5}
PRETRAIN = ["Point_M2AE", "Point_MDAE_with_fc_center_p", "Point_M2AE_with_fc_center_p",
            "Point_M2AE_with_fc_center_p_v1", "Point_MDAE_with_fc_center_p_v1"]
CORRUPT_KEY = jax.random.key(21)
# a few parameters whose gradients are compared: the first embedding, a
# block of the packed stage, the propagation, the head, the mask token
GRAD_KEYS = ("h_encoder/token_embed0/conv1/kernel", "h_encoder/token_embed1/conv3/kernel",
             "h_encoder/stage2/block0/attn/qkv/kernel", "h_encoder/stage1/block0/mlp_fc2/kernel",
             "token_prop0/fuse_conv/kernel", "token_prop0/res0_conv2/kernel",
             "h_decoder1/block0/attn/proj/kernel", "rec_head/kernel", "mask_token")


def _cloud(seed=3):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, N, 3))
    nrm = rng.normal(size=(B, N, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([xyz, nrm], -1).astype(np.float32)


def _draws(seed=4):
    """The coarsest mask (MASKED of 8 a cloud) and the keep masks of the
    stages with a nonzero rate (encoder stages 1, 2; decoder stage 1), each
    with a drop."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, GROUPS[-1]), bool)
    for b in range(B):
        mask[b, rng.permutation(GROUPS[-1])[:MASKED]] = True
    dp = {name: np.ones((1, 2, B), bool) for name in ("stage1", "stage2", "h_decoder1")}
    dp["stage1"][0, 0, 1] = False
    dp["stage2"][0, 1, 0] = dp["stage2"][0, 0, 3] = False
    dp["h_decoder1"][0, 0, 0] = False
    return mask, dp


def _port(name, seed=0):
    return build_model_from_cfg(ConfigDict(dict(copy.deepcopy(MODEL), NAME=name)),
                                device="cpu", seed=seed)


def _jax_patches(mp, mask, dp):
    """Feed the draws to the JAX package: the mask, the keep masks by stage
    name, the list corruption from CORRUPT_KEY."""
    mp.setattr(jm2ae, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
    mp.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
               if det or max(dpr) == 0.0 else jnp.asarray(dp[mod.name]))
    orig = jm2ae.corrupt_patches_multi
    mp.setattr(jm2ae, "corrupt_patches_multi",
               lambda key, n, c, t: orig(CORRUPT_KEY, n, c, t))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ parts

def test_pyramid_group_matches_jax():
    pts = _cloud()[..., :3]
    jn, jc, ji = jax.jit(lambda p: jm2ae.pyramid_group(p, GROUPS, SIZES))(pts)
    tn, tc, ti = tm2ae.pyramid_group(_t(pts), GROUPS, SIZES)
    for s in range(3):
        assert np.array_equal(ti[s].numpy(), np.asarray(ji[s]))
        np.testing.assert_allclose(tc[s].numpy(), np.asarray(jc[s]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tn[s].numpy(), np.asarray(jn[s]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_backprop_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vis = rng.uniform(size=(3, 8)) < 0.4
    idx = rng.integers(0, 20, size=(3, 8, 5)).astype(np.int32)
    want = np.asarray(jm2ae.backprop_mask(jnp.asarray(vis), jnp.asarray(idx), 20))
    got = tm2ae.backprop_mask(_t(vis), _t(idx), 20).numpy()
    assert np.array_equal(got, want) and want.any() and not want.all()


class _Holder(nn.Module):
    """A module under the torch name ``encoder`` (so the bridge's patch
    encoder rules name its tensors)."""

    def __init__(self, mod):
        super().__init__()
        self.encoder = mod


@pytest.mark.parametrize("in_c,out_c", [(3, 16), (16, 32)])
def test_token_embed_matches_jax(in_c, out_c):
    """The token embedding (``PatchEncoder`` with ``in_channels``): train
    mode, the embedding and both BatchNorms' new running statistics (over
    all B G S rows); eval mode on those statistics."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 6, 5, in_c)).astype(np.float32)
    mod = PatchEncoder(out_c, generator=torch.Generator().manual_seed(1), in_channels=in_c)
    p, s = to_flax(_Holder(mod).state_dict())
    jmod = jm2ae.TokenEmbed(out_c)
    want, upd = jax.jit(lambda v: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": p["encoder"], "batch_stats": s["encoder"]})
    got = mod.train()(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _, s2 = to_flax(_Holder(mod).state_dict())
    for k, v in _flatten(upd["batch_stats"]).items():
        np.testing.assert_allclose(_flatten(s2["encoder"])[k], v, rtol=1e-4, atol=1e-6)
    want_eval = jax.jit(lambda v: jmod.apply(v, x, train=False))(
        {"params": p["encoder"], "batch_stats": upd["batch_stats"]})
    with torch.no_grad():
        got_eval = mod.eval()(_t(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=1e-4, atol=1e-5)


def test_token_prop_matches_jax():
    """Train mode (batch statistics, exact GELU) over (B, 16, 80) -> 32 with
    two residual units."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 16, 80)).astype(np.float32)

    class H(nn.Module):
        def __init__(self):
            super().__init__()
            self.token_prop = nn.ModuleList([tm2ae.TokenProp(80, 32, 2,
                                                             torch.Generator().manual_seed(2))])

    h = H()
    p, s = to_flax(h.state_dict())
    want, _ = jm2ae.TokenProp(32, blocks=2).apply(
        {"params": p["token_prop0"], "batch_stats": s["token_prop0"]}, x, train=True,
        mutable=["batch_stats"])
    got = h.token_prop[0].train()(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_corrupt_patches_multi_matches_jax():
    """One affine draw a position applied to every scale; unknown families
    raise in both packages."""
    tn, tc, _ = tm2ae.pyramid_group(_t(_cloud()[..., :3]), GROUPS, SIZES)
    neighs = [(n + c[:, :, None, :]).numpy() for n, c in zip(tn, tc)]
    centers = [c.numpy() for c in tc]
    key = jax.random.key(5)
    jn, jc = jax.jit(lambda n, c: jcp.corrupt_patches_multi(key, n, c, CORRUPT))(
        neighs, centers)
    draws = patch_draws(key, CORRUPT, (B, GROUPS[0], SIZES[0]))
    gn, gc = corrupt_patches_multi([_t(n) for n in neighs], [_t(c) for c in centers],
                                   CORRUPT, draws)
    for s in range(3):
        np.testing.assert_allclose(gn[s].numpy(), np.asarray(jn[s]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gc[s].numpy(), np.asarray(jc[s]), rtol=1e-5, atol=1e-5)
        assert not np.allclose(gc[s].numpy(), centers[s])
    for mod in (jcp, None):
        with pytest.raises(NotImplementedError):
            if mod is None:
                corrupt_patches_multi([_t(n) for n in neighs], [_t(c) for c in centers],
                                      ["jitter"])
            else:
                mod.corrupt_patches_multi(key, neighs, centers, ["jitter"])


@pytest.mark.parametrize("noaug", [False, True], ids=["masked", "noaug"])
def test_h_encoder_matches_jax(noaug):
    """Per-scale features and masks, train mode with the stages' keep
    masks: masked (the coarsest stage packed to V = 2 slots, the finer in
    place) and noaug (every stage in place)."""
    model = _port("Point_M2AE")
    params, stats = to_flax(model.state_dict())
    mask, dp = _draws()
    pts = _cloud()[..., :3]
    tn, tc, ti = tm2ae.pyramid_group(_t(pts), GROUPS, SIZES)
    jenc = jm2ae.HEncoder(tuple(DIMS), (1, 1, 1), 2, 0.1, 0.8)
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, mask, dp)
        (jf, jmasks), _ = jax.jit(lambda n, c, i: jenc.apply(
            {"params": params["h_encoder"], "batch_stats": stats["h_encoder"]}, n, c, i,
            noaug=noaug, train=True, rngs={"mask": jax.random.key(0),
                                           "droppath": jax.random.key(1)},
            mutable=["batch_stats"]))([n.numpy() for n in tn], [c.numpy() for c in tc],
                                      [i.numpy() for i in ti])
    model.train()
    tdp = [None, _t(dp["stage1"]), _t(dp["stage2"])]
    tf, tmasks = model.h_encoder(tn, tc, ti, None if noaug else _t(mask), tdp)
    for s in range(3):
        assert np.array_equal(tmasks[s].numpy(), np.asarray(jmasks[s]))
        np.testing.assert_allclose(tf[s].detach().numpy(), np.asarray(jf[s]),
                                   rtol=1e-4, atol=1e-4)
    assert tmasks[-1].numpy().sum() == (0 if noaug else B * MASKED)


# ------------------------------------------------------------------ models

def _jax_losses(name, params, stats, clean, mask, dp, grads=False):
    """(losses, flat gradients of their sum or None) of the JAX model."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, mask, dp)
        model = j_build(JConfigDict(dict(copy.deepcopy(MODEL), NAME=name)))
        keys = {k: jax.random.key(i) for i, k in enumerate(("corrupt", "mask", "droppath"))}

        def loss_fn(p, x):
            (l1, l2), _ = model.apply({"params": p, "batch_stats": stats}, x, x, train=True,
                                      rngs=keys, mutable=["batch_stats"])
            return l1 + l2, (l1, l2)

        if grads:
            (_, losses), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                params, jnp.asarray(clean))
            return [float(v) for v in losses], _flatten(jax.tree_util.tree_map(np.asarray, g))
        _, losses = jax.jit(loss_fn)(params, jnp.asarray(clean))
    return [float(v) for v in losses], None


@functools.lru_cache(maxsize=None)
def _pretrain_case(name, grads):
    """(port model after its backward, port losses, JAX losses, JAX
    gradients or None, the smallest |pre-activation| of the coarse heads'
    ReLUs in the port: with B 4 one ReLU gate of a head decides a whole
    column of the next layer's gradient, so the clouds keep every gate
    away from its tie)."""
    model = _port(name)
    params, stats = to_flax(model.state_dict())
    clean = _cloud(CLOUD_SEED)
    mask, dp = _draws()
    gates = []
    for i in range(3 if hasattr(model, "coarse_pred") else 0):
        for j in (0, 2):
            model.coarse_pred(i)[j].register_forward_hook(
                lambda m, a, o: gates.append(float(o.detach().abs().min())))
    want, gj = _jax_losses(name, params, stats, clean, mask, dp, grads)
    model.train()
    x = _t(clean)
    corrupt = patch_draws(CORRUPT_KEY, CORRUPT, (B, GROUPS[0], SIZES[0]))
    draws = tm2ae.M2AEDraws(_t(mask), corrupt, [None, _t(dp["stage1"]), _t(dp["stage2"])],
                            [None, _t(dp["h_decoder1"])])
    l1, l2 = model(x, x, draws=draws)
    if grads:
        (l1 + l2).backward()
    return model, [float(l1.detach()), float(l2.detach())], want, gj, min(gates, default=1.0)


def _check_grads(model, gj, keys):
    gt = _flatten(to_flax({n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None})[0])
    for k in keys:
        np.testing.assert_allclose(gt[k], gj[k], rtol=0,
                                   atol=1e-3 * np.abs(gj[k]).max(), err_msg=k)
        assert np.abs(gj[k]).max() > 0, k


@pytest.mark.parametrize("name", PRETRAIN)
def test_pretrain_losses_match_jax(name):
    """Both losses within 1e-4 relative (``Point_M2AE``'s second is 0);
    the gradients of GRAD_KEYS (for the corrupted model, the coarse heads'
    and not the scale-0 embedding's inner layers) within 1e-3 of their
    largest for ``Point_M2AE`` and ``Point_MDAE_with_fc_center_p``."""
    grads = name in ("Point_M2AE", "Point_MDAE_with_fc_center_p")
    model, got, want, gj, gate = _pretrain_case(name, grads)
    assert gate > 5e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert want[0] > 0
    assert (want[1] == 0) == (name == "Point_M2AE")
    if grads and name == "Point_M2AE":
        _check_grads(model, gj, GRAD_KEYS)
    elif grads:
        # the scale-0 embedding's inner layers are left out here: the
        # affine corruption's multiplicative translate (a factor in
        # (-0.5, 0.5) an axis) squeezes patches until points tie within
        # rounding in its max over each patch, and the two packages send
        # such an element's gradient to different points
        keys = tuple(k for k in GRAD_KEYS if not k.startswith("h_encoder/token_embed0/"))
        _check_grads(model, gj, keys + ("h_encoder/token_embed0/conv4/kernel",
                                        "coarse_pred_0/dense2/kernel",
                                        "coarse_pred_2/dense0/kernel"))


def test_corruption_moves_only_the_mdae_losses():
    """The corrupted variants differ from their clean twins on the same
    weights and draws; the clean twins agree with each other."""
    l = {n: _pretrain_case(n, n in ("Point_M2AE", "Point_MDAE_with_fc_center_p"))[1]
         for n in PRETRAIN[1:]}
    assert l["Point_M2AE_with_fc_center_p"] == l["Point_M2AE_with_fc_center_p_v1"]
    assert l["Point_MDAE_with_fc_center_p"] == l["Point_MDAE_with_fc_center_p_v1"]
    assert l["Point_MDAE_with_fc_center_p"] != l["Point_M2AE_with_fc_center_p"]


def test_svm_feature_matches_jax():
    """Eval mode on BatchNorm statistics set away from (0, 1): mean + max of
    the coarsest scale's unmasked tokens."""
    model = _port("Point_M2AE_SVMFeature").eval()
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(_t(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)) if "var" in n
                    else _t(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    params, stats = to_flax(model.state_dict())
    jmodel = j_build(JConfigDict(dict(copy.deepcopy(MODEL), NAME="Point_M2AE_SVMFeature")))
    pts = _cloud()[..., :3]
    want = jax.jit(lambda p: jmodel.apply({"params": params, "batch_stats": stats}, p,
                                          train=False))(pts)
    with torch.no_grad():
        got = model(_t(pts))
    assert got.shape == (B, DIMS[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _dropout_interceptor(masks):
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            return jnp.where(jnp.asarray(masks[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)
    return intercept


def test_finetune_logits_and_grads_match_jax():
    """Train mode (the encoder unmasked with its keep masks, the head's
    dropouts) and eval mode: logits within 1e-4 relative; the gradients of
    a cross-entropy through both within 1e-3 of their largest."""
    model = _port("Point_M2AE_Finetune")
    params, stats = to_flax(model.state_dict())
    _, dp = _draws()
    rng = np.random.default_rng(10)
    drop = {"dp0": rng.uniform(size=(B, 256)) >= 0.5, "dp1": rng.uniform(size=(B, 256)) >= 0.5}
    pts = _cloud()[..., :3]
    labels = np.array([1, 3, 0, 4])
    jmodel = j_build(JConfigDict(dict(copy.deepcopy(MODEL), NAME="Point_M2AE_Finetune")))
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, None, dp)

        def loss_fn(p, x):
            logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     rngs={"dropout": jax.random.key(0),
                                           "droppath": jax.random.key(1)},
                                     mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], -1)), logits

        with fnn.intercept_methods(_dropout_interceptor(drop)):
            (_, jl), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, pts)
    j_eval = jax.jit(lambda p: jmodel.apply({"params": params, "batch_stats": stats}, p,
                                            train=False))(pts)
    with torch.no_grad():
        got_eval = model.eval()(_t(pts))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(j_eval), rtol=1e-4, atol=1e-5)
    model.train()
    draws = ClsDraws([_t(drop["dp0"]), _t(drop["dp1"])],
                     [None, _t(dp["stage1"]), _t(dp["stage2"])])
    logits = model(_t(pts), draws=draws)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    logp = torch.log_softmax(logits, -1)
    (-logp.gather(-1, _t(labels)[:, None]).mean()).backward()
    _check_grads(model, _flatten(jax.tree_util.tree_map(np.asarray, gj)),
                 ("h_encoder/token_embed0/conv1/kernel", "h_encoder/stage2/block0/attn/qkv/kernel",
                  "cls_head_finetune/fc0/kernel", "cls_head_finetune/cls/kernel"))


@pytest.mark.parametrize("name", PRETRAIN + ["Point_M2AE_SVMFeature", "Point_M2AE_Finetune"])
def test_m2ae_weights_carry_across_both_ways(name):
    """A state dict -> flax tree -> state dict is the identity, and the tree
    has the JAX model's paths and shapes."""
    cfg = JConfigDict(dict(copy.deepcopy(MODEL), NAME=name))
    jmodel = j_build(cfg)
    x = jnp.zeros((B, N, 3), jnp.float32)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "corrupt", "mask", "droppath",
                                                         "dropout"))}
    if name in PRETRAIN:
        init = lambda: jmodel.init(rngs, x, x, train=False)  # noqa: E731
    else:
        init = lambda: jmodel.init(rngs, x, train=False)  # noqa: E731
    shapes = jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32),
                                    jax.eval_shape(init))
    model = _port(name)
    sd = model.state_dict()
    p, s = to_flax(sd)
    flat = lambda tree: {k: np.shape(v) for k, v in _flatten(tree).items()}  # noqa: E731
    assert flat(p) == flat(shapes["params"])
    assert flat(s) == flat(shapes["batch_stats"])
    back = from_flax(p, s)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
