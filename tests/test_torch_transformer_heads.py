"""The 13 PointCAE transformer heads of the port (``models/transformer.py``)
against the JAX package on the CPU, at a tiny width (B 4, 128 points, G 16,
S 8, dim 32, depth 2, one decoder block, 2 heads; ``fc_all``'s model
``npoints`` 128), every case in one jitted JAX function: the same clouds
(numpy seeds), the same weights (the port's, running statistics moved off
their initial values, through ``to_flax``), the same draws (the patch mask,
the ``affine_r3`` patch corruption, the stochastic-depth keep masks by stack
name and the supervised head's dropout keep masks by module name, fed to
the JAX package through monkeypatch and ``intercept_methods``). The v6
heads run unmasked (``['affine_r3']``), as the reference refuses
``Drop-Patch`` for them.

Held: in train mode both losses (f32) within 1e-5 relative and the new
running statistics within 1e-5; in eval mode every gradient within 1e-4 of
its leaf's largest, or where f32 rounding settles a near-tie apart in the
two packages (a chamfer neighbour, a max-pool's maximum) by norm, as
``tests/_cnn_zoo.py:grad_close`` holds the CNN zoo's; one bf16 case's losses
within 1e-3; the weight bridge both ways for every head; the v6 heads'
``Drop-Patch`` refusal in both packages."""
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from _cnn_zoo import grad_close
from point_dae_tpu.data import corruptions_patch as jcp
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.data.corruptions_patch import AffineR3Draws
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import ModelDraws, SupervisedDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, G, S, C = 4, 128, 16, 8, 32
MASKED = 10                                    # within [floor(0.5 G), floor(0.8 G)]
CLS = 55
HEADS = (
    "PointCAE_transformer", "PointCAE_transformer_fc_global_fc_local",
    "PointCAE_transformer_folding", "PointCAE_transformer_folding_global_folding_local",
    "PointCAE_transformer_folding_global_fc_local", "PointCAE_transformer_patch_center_only",
    "PointCAE_transformer_fc_center", "PointCAE_transformer_fold_center",
    "PointCAE_transformer_fc_all", "PointCAE_transformer_fold_all",
    "PointCAE_transformer_v6_corase2fine_transformer",
    "PointCAE_transformer_v6_folding_corase2fine_transformer",
    "PointCAE_transformer_supervised")
BF16 = "PointCAE_transformer_folding_global_folding_local"
CASES = [(h, False) for h in HEADS] + [(BF16, True)]


def _config(name, bf16=False, masked=None):
    cfg = copy.deepcopy(_tiny_config()["model"])
    cfg.update(NAME=name, npoints=N, group_size=S, num_group=G)
    cfg["transformer_config"].update(trans_dim=C, encoder_dims=C, depth=2, num_heads=2,
                                     decoder_depth=1, decoder_num_heads=2)
    if not bf16:
        del cfg["transformer_config"]["dtype"]
    if not (masked if masked is not None else "v6" not in name):
        cfg["corrupt_type"] = ["affine_r3"]
    return cfg


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(name, bf16=False):
    """The port model with its BatchNorm running statistics off their
    initial values (so that eval mode reads them)."""
    model = build_model_from_cfg(ConfigDict(_config(name, bf16)), device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
            elif n.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    return model


def _draws():
    """The mask, the affine_r3 draws (three families, from a JAX key), the
    keep masks of both stacks (each with drops) and of the supervised
    head's two dropouts, the labels."""
    rng = np.random.default_rng(8)
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:MASKED]] = True
    _, _, A, bvec, m = jax.device_get(jcp._sample_affine_r3(jax.random.key(5), B, False))
    affine = (3, np.array([2, 4, 0, 1, 3], np.int32), np.asarray(A), np.asarray(bvec),
              np.asarray(m))
    dp = {"blocks": rng.uniform(size=(2, 2, B)) >= 0.3,
          "MAE_decoder": rng.uniform(size=(1, 2, B)) >= 0.3}
    dp["blocks"][1, 0, 1] = dp["MAE_decoder"][0, 1, 2] = False
    drop = {f"dp{i}": rng.uniform(size=(B, 256)) >= 0.5 for i in range(2)}
    labels = rng.integers(0, CLS, B)
    clouds = rng.normal(size=(B, N, 3)).astype(np.float32)
    return mask, affine, dp, drop, labels, clouds


@functools.lru_cache(maxsize=None)
def _jax_results():
    """{(name, bf16): (train losses, new running statistics, eval loss,
    eval gradients)} of every case in one jit."""
    mask, affine, dp, drop, labels, clouds = _draws()
    models = {c: j_build(JConfigDict(_config(*c))) for c in CASES}
    weights = {c: to_flax(_port(*c).state_dict()) for c in CASES}
    count, perm, A, bvec, m = affine

    def corrupt(key, neigh, center, types, fix_translate_bug=False):
        assert tuple(types) in (("affine_r3", "Drop-Patch"), ("affine_r3",)), types
        return jcp._apply_affine_r3((jnp.int32(count), jnp.asarray(perm), jnp.asarray(A),
                                     jnp.asarray(bvec), jnp.asarray(m)), neigh, center)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            return jnp.where(jnp.asarray(drop[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    def one(c, params, stats, x, y):
        model = models[c]
        kw = {"labels": y} if c[0].endswith("supervised") else {}
        rngs = {k: jax.random.key(i) for i, k in enumerate(("corrupt", "mask", "droppath",
                                                             "dropout"))}
        (l1, l2), upd = model.apply({"params": params, "batch_stats": stats}, x, x,
                                    train=True, rngs=rngs, mutable=["batch_stats"], **kw)

        if c[1]:                                     # bf16: the losses alone
            return (l1, l2), upd["batch_stats"], 0.0, {}

        def eval_loss(p):
            a, b = model.apply({"params": p, "batch_stats": stats}, x, x, train=False,
                               rngs=rngs, **kw)
            return a + b

        loss, grads = jax.value_and_grad(eval_loss)(params)
        return (l1, l2), upd["batch_stats"], loss, grads

    def fn(weights, x, y):
        return {c: one(c, *weights[c], x, y) for c in CASES}

    with pytest.MonkeyPatch.context() as mp, fnn.intercept_methods(intercept):
        mp.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
        mp.setattr(jtr, "corrupt_patches", corrupt)
        mp.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                   if det or max(dpr) == 0.0 else jnp.asarray(dp[mod.name]))
        res = jax.device_get(jax.jit(fn)(weights, jnp.asarray(clouds), jnp.asarray(labels)))
    flat = lambda tree: _flatten(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    return {c: ([float(v) for v in losses], flat(stats), float(loss), flat(grads))
            for c, (losses, stats, loss, grads) in res.items()}


def _port_run(name, bf16=False):
    """(train losses, new running statistics, eval loss, eval gradients) of
    the port on the same case."""
    mask, affine, dp, drop, labels, clouds = _draws()
    count, perm, A, bvec, m = affine
    corrupt = [AffineR3Draws(count, perm.tolist(), _t(A), _t(bvec), _t(m))]
    masked = "v6" not in name
    if masked:
        corrupt.append(None)
    model = _port(name, bf16)
    has_decoder = hasattr(model, "MAE_decoder")
    x = _t(clouds)
    kw = {"labels": _t(labels)} if name.endswith("supervised") else {}
    eval_model = copy.deepcopy(model).eval()
    draws = ModelDraws(_t(mask) if masked else None, corrupt, _t(dp["blocks"]),
                       _t(dp["MAE_decoder"]) if has_decoder else None)
    if kw:
        draws = SupervisedDraws(**vars(draws), dropout=[_t(drop["dp0"]), _t(drop["dp1"])])
    with torch.no_grad():
        l1, l2 = model.train()(x, x, draws=draws, **kw)
    stats = _flatten(to_flax(model.state_dict())[1])
    if bf16:
        return [float(l1), float(l2)], stats, None, None
    e1, e2 = eval_model(x, x, draws=ModelDraws(_t(mask) if masked else None, None, None, None),
                        **kw)
    (e1 + e2).backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in eval_model.named_parameters()}
    return [float(l1), float(l2)], stats, float((e1 + e2).detach()), _flatten(to_flax(grads)[0])


@pytest.mark.parametrize("name,bf16", CASES, ids=[f"{n}{'-bf16' if b else ''}" for n, b in CASES])
def test_head_matches_jax(name, bf16):
    """Train-mode losses and running statistics; in f32, the eval-mode
    loss and every gradient."""
    jl, js, jloss, jg = _jax_results()[(name, bf16)]
    tl, ts, tloss, tg = _port_run(name, bf16)
    assert jl[0] > 0 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if bf16 else 1e-5, err_msg=name)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-5 * np.abs(js[k]).max(),
                                   err_msg=f"{name} {k}")
    if bf16:
        return
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, err_msg=name)
    assert set(tg) == set(jg), sorted(set(tg) ^ set(jg))
    top = max(np.abs(g).max() for g in jg.values())
    bad = [k for k in sorted(jg) if not grad_close(tg[k], jg[k], top)]
    assert not bad, [(k, float(np.abs(tg[k] - jg[k]).max()), float(np.abs(jg[k]).max()))
                     for k in bad[:4]]


@pytest.mark.parametrize("name", HEADS)
def test_weights_carry_across_both_ways(name):
    """``to_flax`` gives the JAX model's paths and shapes; ``from_flax``
    (with the model's names) inverts it bit for bit and loads strictly."""
    jmodel = j_build(JConfigDict(_config(name)))
    x = jnp.zeros((B, N, 3), jnp.float32)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "mask", "droppath"))}
    shapes = jax.eval_shape(lambda: jmodel.init(rngs, x, x, train=False))
    model = _port(name)
    sd = model.state_dict()
    p, s = to_flax(sd)
    flat = lambda tree: {k: tuple(np.shape(v)) for k, v in _flatten(  # noqa: E731
        jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32), tree)).items()}
    assert flat(p) == flat(shapes["params"])
    assert flat(s) == flat(shapes.get("batch_stats", {}))
    back = from_flax(p, s, names=sd)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", [h for h in HEADS if "v6" in h])
def test_v6_heads_refuse_drop_patch_in_both_packages(name):
    """Under ``Drop-Patch`` both packages build the v6 heads (mask token
    included) and refuse their forward."""
    cfg = _config(name, masked=True)
    jmodel = j_build(JConfigDict(cfg))
    x = jnp.zeros((B, N, 3), jnp.float32)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "mask", "droppath",
                                                         "corrupt"))}
    with pytest.raises(NotImplementedError):
        jax.eval_shape(lambda: jmodel.init(rngs, x, x, train=True))
    model = build_model_from_cfg(ConfigDict(cfg), device="cpu")
    assert model.masked_mode and model.mask_token.shape == (1, 1, C)
    with pytest.raises(NotImplementedError):
        model(torch.zeros(B, N, 3), torch.zeros(B, N, 3))
