"""``Point_MlMAE``, ``PointTransformerMlMAE`` and its linear probe of the
port against the JAX package on the CPU, at a tiny width (B 4, 256
points, G 16, S 8, dim 32, 2 heads, depth 12 so that every level of
``fetch_idx`` exists, 4 decoder blocks so that every ``feat_loss`` level
is on): the same clouds (numpy seeds), the same weights (the port's
initial ones through ``to_flax(..., family="mlmae")``), the same draws
(the patch mask, or under ``mask_type: block`` the JAX key's seed patches;
the stochastic-depth keep masks fed to the JAX blocks' ``drop_path`` in
the order the trace calls it; the fine-tune head's dropout masks through
``flax.linen.intercept_methods``). Tolerances: losses and eval logits
within 1e-4 relative, train-mode logits and gradients within 1e-3 of their
largest, the BatchNorm statistics after the step within 1e-5 relative,
features within 1e-4."""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import mlmae as jmlmae
from point_dae_tpu.models import transformer as jtransformer
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.models.layers import stack_dp_masks
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, G, S, C, DEPTH, DEC = 4, 256, 16, 8, 32, 12, 4
MASKED = 9                                     # floor(0.6 * 16)
BLOCK_KEY = jax.random.key(13)
LEVELS = ["high0", "high1", "high2", "high3"]


def _config(name="Point_MlMAE", mask_type="rand", mask_ratio=0.6):
    return {"NAME": name, "corrupt_type": ["Drop-Patch"], "group_size": S, "num_group": G,
            "loss": "cdl2", "feat_loss": LEVELS, "cls_dim": 5,
            "transformer_config": {"rand_ratio": "False", "mask_ratio": mask_ratio,
                                   "mask_type": mask_type, "trans_dim": C, "encoder_dims": C,
                                   "depth": DEPTH, "drop_path_rate": 0.1, "num_heads": 2,
                                   "decoder_depth": DEC, "decoder_num_heads": 2}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed=3):
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


def _dp_masks(rng, depth):
    m = rng.uniform(size=(depth, 2, B)) >= 0.3
    m[1, 0, 1] = m[depth - 1, 1, 2] = False
    return m


def _drop_path_calls(*stacks):
    """The keep masks in the order the JAX blocks call ``drop_path`` (block
    0 of a stack has rate 0 and draws none)."""
    return [s[i, j] for s in stacks for i in range(1, s.shape[0]) for j in range(2)]


def _jax_fn(fn, masks, dp_calls):
    """``fn`` traced with the patch masks (in the order the models draw
    them), the block seeds of BLOCK_KEY and the keep masks fed in."""
    orig_block = jtransformer.sample_block_mask

    def run(*args):
        mask_calls, calls = iter(masks), iter(dp_calls)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmlmae, "sample_patch_mask",
                       lambda *a, **k: jnp.asarray(next(mask_calls)))
            mp.setattr(jmlmae, "sample_block_mask",
                       lambda key, centers, ratio: orig_block(BLOCK_KEY, centers, ratio))
            mp.setattr(jlayers, "drop_path", lambda key, x, rate, det: jlayers.drop_path_from_mask(
                x, jnp.asarray(next(calls)), rate))
            return jax.jit(fn)(*args)
    return run


PRETRAIN = [("rand", 0.6), ("block", 0.6), ("rand", 0.05)]


@functools.lru_cache(maxsize=None)
def _pretrain_cases():
    """{(mask_type, mask_ratio): (port losses, JAX losses, port gradients,
    JAX gradients, port and JAX BatchNorm statistics after the step)} for
    PRETRAIN, the JAX side in one jit, gradients for the first case only.
    The cases share the weights (the port's initial ones, seed 0), the
    clouds and the keep masks."""
    rng = np.random.default_rng(4)
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:MASKED]] = True
    masks = {0.6: mask, 0.05: np.zeros((B, G), bool)}     # floor(0.05 * 16) = 0
    dp_enc, dp_dec = _dp_masks(rng, DEPTH), _dp_masks(rng, DEC)
    seed_idx = np.asarray(jax.random.randint(BLOCK_KEY, (B, 1, 1), 0, G)).reshape(B)
    models = {c: build_model_from_cfg(ConfigDict(_config(mask_type=c[0], mask_ratio=c[1])),
                                      device="cpu", seed=0) for c in PRETRAIN}
    params, stats = to_flax(models[PRETRAIN[0]].state_dict(), family="mlmae")
    clean = _cloud()

    def losses(jmodel):
        def loss_fn(p, x):
            (l1, l2), upd = jmodel.apply({"params": p, "batch_stats": stats}, x, x,
                                         train=True, mutable=["batch_stats"],
                                         rngs={"mask": jax.random.key(0),
                                               "droppath": jax.random.key(1)})
            return l1 + l2, ((l1, l2), upd["batch_stats"])
        return loss_fn

    jmodels = [j_build(JConfigDict(_config(mask_type=c[0], mask_ratio=c[1]))) for c in PRETRAIN]

    def all_cases(p, x):
        first = jax.value_and_grad(losses(jmodels[0]), has_aux=True)(p, x)
        return [first] + [(losses(jm)(p, x), {}) for jm in jmodels[1:]]

    drawn = [masks[c[1]] for c in PRETRAIN if c[0] == "rand"]
    outs = _jax_fn(all_cases, drawn, _drop_path_calls(dp_enc, dp_dec) * len(PRETRAIN))(
        params, clean)
    out = {}
    for (mask_type, ratio), ((_, (jl, jstats)), gj) in zip(PRETRAIN, outs):
        model = models[(mask_type, ratio)].train()
        block = mask_type == "block"
        draws = ModelDraws(None if block else _t(masks[ratio]), None, _t(dp_enc), _t(dp_dec),
                           _t(seed_idx) if block else None)
        x = _t(clean)
        l1, l2 = model(x, x, draws=draws)
        if gj:
            (l1 + l2).backward()
        gt = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        out[(mask_type, ratio)] = (
            [float(l1.detach()), float(l2.detach())], [float(v) for v in jl],
            _flatten(to_flax(gt, family="mlmae")[0]) if gj else {},
            _flatten(jax.tree_util.tree_map(np.asarray, gj)),
            _flatten(to_flax(model.state_dict(), family="mlmae")[1]),
            _flatten(jax.tree_util.tree_map(np.asarray, jstats)))
    return out


@pytest.mark.parametrize("mask_type,mask_ratio", PRETRAIN)
def test_pretrain_losses_match_jax(mask_type, mask_ratio):
    """Both losses with every ``feat_loss`` level on within 1e-4 relative,
    the BatchNorm statistics after the step (the student's batch, moved
    once: the teacher pass leaves them) within 1e-5: the packed encoder
    under the random and the block mask, and at ratio 0.05 the form with
    no static mask (nothing masked, both losses 0)."""
    got, want, _, _, ts, js = _pretrain_cases()[(mask_type, mask_ratio)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert (min(want) > 0) == (mask_ratio == 0.6)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_pretrain_gradients_match_jax():
    """Under the random mask, the gradients of the patch embedding, an
    encoder block the teacher reads, the decoder, the head and the mask
    token within 1e-3 of their largest."""
    _, _, gt, gj, _, _ = _pretrain_cases()[("rand", 0.6)]
    for k in ("MAE_encoder/encoder/conv1/kernel", "MAE_encoder/block11/attn/qkv/kernel",
              "MAE_encoder/block3/mlp_fc2/kernel", "MAE_encoder/pos_embed/fc1/kernel",
              "MAE_decoder/block0/mlp_fc1/kernel", "MAE_decoder/block3/attn/proj/kernel",
              "decoder_pos_embed/fc2/kernel", "increase_dim/kernel", "mask_token"):
        assert np.abs(gj[k]).max() > 0, k
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=1e-3 * np.abs(gj[k]).max(),
                                   err_msg=k)


def _moved_stats(model, seed=9):
    """BatchNorm statistics moved off their init values, so that the eval
    forwards read them."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(_t(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif n.endswith("running_mean"):
                b.copy_(_t(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    return model


@pytest.mark.parametrize("name", ["Point_MlMAE", "PointTransformerMlMAE",
                                  "PointTransformerMlMAELinearClassification"])
def test_encode_and_eval_logits_match_jax(name):
    """In eval mode: the pretrain model's SVM feature (max + mean of the
    last level) and each fine-tune model's ``encode`` (concat(max, mean))
    within 1e-4, and the fine-tune models' logits within 1e-4 relative."""
    model = _moved_stats(build_model_from_cfg(ConfigDict(_config(name)), device="cpu",
                                              seed=2)).eval()
    params, stats = to_flax(model.state_dict(), family="mlmae")
    jmodel = j_build(JConfigDict(_config(name)))
    pts = _cloud(7)
    v = {"params": params, "batch_stats": stats}
    pretrain = name == "Point_MlMAE"

    @jax.jit               # one compile for the feature and the logits
    def outputs(p):
        feat = jmodel.apply(v, p, train=False, method=jmodel.encode)
        return feat, None if pretrain else jmodel.apply(v, p, train=False)

    want_feat, want = outputs(pts)
    with torch.no_grad():
        got = model.encode(_t(pts))
        logits = None if pretrain else model(_t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-5)
    if not pretrain:
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(want)).max())


def test_finetune_train_logits_match_jax():
    """``PointTransformerMlMAE`` in train mode (stochastic depth and the
    head's dropout fed on both sides): logits within 1e-3 of the largest;
    the head's BatchNorms normalise by the statistics of a batch of 4,
    which magnify f32 rounding (1.3e-4 of the largest seen)."""
    name = "PointTransformerMlMAE"
    model = build_model_from_cfg(ConfigDict(_config(name)), device="cpu", seed=3).train()
    params, stats = to_flax(model.state_dict(), family="mlmae")
    rng = np.random.default_rng(5)
    dp = _dp_masks(rng, DEPTH)
    keep = [rng.uniform(size=(B, 256)) >= 0.5 for _ in range(2)]
    masks = {f"dp{i}": k for i, k in enumerate(keep)}

    def dropout(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__" \
                and not kwargs.get("deterministic", mod.deterministic):
            return jnp.where(jnp.asarray(masks[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    pts = _cloud(8)
    jmodel = j_build(JConfigDict(_config(name)))
    with fnn.intercept_methods(dropout):
        want = _jax_fn(lambda p, x: jmodel.apply(
            {"params": p, "batch_stats": stats}, x, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0), "droppath": jax.random.key(1)})[0],
            [], _drop_path_calls(dp))(params, pts)
    got = model(_t(pts), draws=ClsDraws([_t(k) for k in keep], _t(dp)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("name", ["Point_MlMAE", "PointTransformerMlMAE",
                                  "PointTransformerMlMAELinearClassification"])
def test_weights_carry_across_both_ways(name):
    """``to_flax(..., family="mlmae")`` gives the JAX model's paths and
    shapes (the encoder's blocks directly under ``MAE_encoder``);
    ``from_flax`` inverts it bit for bit and loads strictly; the draws'
    keep masks cover the encoder's blocks."""
    jmodel = j_build(JConfigDict(_config(name)))
    x = jnp.zeros((B, N, 3), jnp.float32)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "mask", "droppath"))}
    args = (x, x) if name == "Point_MlMAE" else (x,)
    shapes = jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32), jax.eval_shape(
        lambda: jmodel.init(rngs, *args, train=False)))
    model = build_model_from_cfg(ConfigDict(_config(name)), device="cpu", seed=0)
    sd = model.state_dict()
    p, s = to_flax(sd, family="mlmae")
    flat = lambda tree: {k: np.shape(v) for k, v in _flatten(tree).items()}  # noqa: E731
    assert flat(p) == flat(shapes["params"])
    assert flat(s) == flat(shapes["batch_stats"])
    back = from_flax(p, s)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    model.load_state_dict(back, strict=True)
    draws = model.sample_draws(B, torch.Generator().manual_seed(0), "cpu")
    dp = draws.dp_encoder if name == "Point_MlMAE" else draws.drop_path
    assert tuple(dp.shape) == (DEPTH, 2, B)
    assert tuple(stack_dp_masks(model.MAE_encoder.blocks.dpr, B, None, "cpu").shape) == \
        (DEPTH, 2, B)
