"""``Point_MAE``, ``Point_MAE_folding`` and ``MaskFeat_transformer`` of the
port against the JAX package on the CPU, at a tiny width (B 4, 256 points,
G 16, S 8, dim 32, depth 1, 2 heads, one decoder block): the same clouds
(numpy seeds; normal clouds, whose kNN patches have no distance ties),
the same weights (the port's initial ones through ``to_flax``), the same
draws (the patch mask, or under ``mask_type: block`` the JAX key's seed
patches, and the stochastic-depth keep masks by stack name, fed to the
JAX package through monkeypatch). Compared: both losses within 1e-4
relative, a few gradients within 1e-3 of their largest, the BatchNorm
statistics after the step, the SVM probe's feature in eval mode, the
weight bridge both ways and the teacher's checkpoint merge."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtransformer
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.engine.pretrain import _teacher_state
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.utils.checkpoint import merge_pretrained
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, G, S, C = 4, 256, 16, 8, 32
MASKED = 9                                     # floor(0.6 * 16)
BLOCK_KEY = jax.random.key(13)


def _config(name, mask_type="rand"):
    return {"NAME": name, "corrupt_type": ["Drop-Patch"], "group_size": S, "num_group": G,
            "loss": "cdl2",
            "transformer_config": {"rand_ratio": "False", "mask_ratio": 0.6,
                                   "mask_type": mask_type, "trans_dim": C, "encoder_dims": C,
                                   "depth": 1, "drop_path_rate": 0.1, "num_heads": 2,
                                   "decoder_depth": 1, "decoder_num_heads": 2}}


CASES = [("Point_MAE", "rand"), ("Point_MAE", "block"), ("Point_MAE_folding", "rand"),
         ("MaskFeat_transformer", "rand")]
GRADS = (("Point_MAE", "rand"), ("MaskFeat_transformer", "rand"))   # the others: losses
GRAD_KEYS = {"Point_MAE": ("increase_dim/kernel",),
             "MaskFeat_transformer": ("increase_dim/kernel",)}
COMMON_GRADS = ("MAE_encoder/encoder/conv1/kernel", "MAE_encoder/encoder/conv4/kernel",
                "MAE_encoder/blocks/block0/attn/qkv/kernel", "MAE_encoder/pos_embed/fc1/kernel",
                "MAE_decoder/block0/mlp_fc1/kernel", "decoder_pos_embed/fc2/kernel",
                "mask_token")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cloud(seed=3):
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


def _draws(seed=4):
    """The patch mask (MASKED of G a cloud), the block mask's seed patches
    (those the JAX package draws from BLOCK_KEY) and the keep masks of the
    encoder and decoder stacks, each with a drop."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:MASKED]] = True
    seed_idx = np.asarray(jax.random.randint(BLOCK_KEY, (B, 1, 1), 0, G)).reshape(B)
    dp = {name: rng.uniform(size=(1, 2, B)) >= 0.3 for name in ("blocks", "MAE_decoder")}
    dp["blocks"][0, 0, 1] = dp["MAE_decoder"][0, 1, 2] = False
    return mask, seed_idx, dp


def _port(name, mask_type="rand", seed=0):
    return build_model_from_cfg(ConfigDict(_config(name, mask_type)), device="cpu", seed=seed)


@functools.lru_cache(maxsize=None)
def _case(name, mask_type):
    """(port model after its backward, port losses, JAX losses, JAX
    gradients (for GRADS, else empty), JAX batch statistics)."""
    grads = (name, mask_type) in GRADS
    model = _port(name, mask_type)
    params, stats = to_flax(model.state_dict())
    clean = _cloud()
    mask, seed_idx, dp = _draws()
    jmodel = j_build(JConfigDict(_config(name, mask_type)))
    orig_block = jtransformer.sample_block_mask
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtransformer, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
        mp.setattr(jtransformer, "sample_block_mask",
                   lambda key, centers, ratio: orig_block(BLOCK_KEY, centers, ratio))
        mp.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                   if det or max(dpr) == 0.0 else jnp.asarray(dp[mod.name]))

        def loss_fn(p, x):
            (l1, l2), upd = jmodel.apply({"params": p, "batch_stats": stats}, x, x, train=True,
                                         mutable=["batch_stats"],
                                         rngs={k: jax.random.key(i) for i, k in
                                               enumerate(("mask", "droppath"))})
            return l1 + l2, ((l1, l2), upd["batch_stats"])

        if grads:
            (_, (jl, jstats)), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                params, clean)
        else:
            _, (jl, jstats) = jax.jit(loss_fn)(params, clean)
            gj = {}
    model.train()
    draws = ModelDraws(None if mask_type == "block" else _t(mask), None, _t(dp["blocks"]),
                       _t(dp["MAE_decoder"]), _t(seed_idx) if mask_type == "block" else None)
    x = _t(clean)
    l1, l2 = model(x, x, draws=draws)
    if grads:
        (l1 + l2).backward()
    return (model, [float(l1), float(l2)], [float(v) for v in jl],
            _flatten(jax.tree_util.tree_map(np.asarray, gj)),
            _flatten(jax.tree_util.tree_map(np.asarray, jstats)))


@pytest.mark.parametrize("name,mask_type", CASES)
def test_losses_and_gradients_match_jax(name, mask_type):
    """Losses within 1e-4 relative (the second is 0); the BatchNorm
    statistics after the step within 1e-5 relative (the teacher's
    unchanged); for GRADS the gradients of the encoder, decoder, head and
    mask token within 1e-3 of their largest, the teacher's none at all
    (JAX: exactly zero). The block mask and the folding head change the
    backward's path only where the forward shows it, so their cases
    compare the forward."""
    model, got, want, gj, jstats = _case(name, mask_type)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[0] > 0 and got[1] == want[1] == 0.0
    ts = _flatten(to_flax(model.state_dict())[1])
    assert set(ts) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(ts[k], jstats[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if (name, mask_type) not in GRADS:
        return
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    gt = _flatten(to_flax(grads)[0])
    for k in COMMON_GRADS + GRAD_KEYS[name]:
        assert np.abs(gj[k]).max() > 0, k
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=1e-3 * np.abs(gj[k]).max(),
                                   err_msg=k)
    teacher = [k for k in gj if k.startswith("teacher/")]
    assert bool(teacher) == (name == "MaskFeat_transformer")
    assert not any(np.abs(gj[k]).max() for k in teacher)
    assert not any(k.startswith("teacher/") for k in gt)


def test_block_mask_reaches_the_encoder():
    """``mask_type: block`` masks the block around each seed patch: the
    loss differs from the random mask's on the same weights."""
    assert _case("Point_MAE", "block")[1][0] != _case("Point_MAE", "rand")[1][0]


@pytest.mark.parametrize("name", ["Point_MAE", "MaskFeat_transformer"])
def test_encode_matches_jax(name):
    """The SVM probe's feature (``noaug``, eval, BatchNorm statistics moved
    off their init values): within 1e-4 relative."""
    model = _port(name)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(_t(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif n.endswith("running_mean"):
                b.copy_(_t(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    params, stats = to_flax(model.state_dict())
    jmodel = j_build(JConfigDict(_config(name)))
    pts = _cloud(7)
    want = jax.jit(lambda p: jmodel.apply({"params": params, "batch_stats": stats}, p,
                                          method=jmodel.encode))(pts)
    with torch.no_grad():
        got = model.eval().encode(_t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["Point_MAE", "Point_MAE_folding", "MaskFeat_transformer",
                                  "MaskFeat_transformer_pointmae",
                                  "MaskFeat_transformer_supervised"])
def test_weights_carry_across_both_ways(name):
    """``to_flax`` gives the JAX model's paths and shapes (the transformer
    teacher's included); ``from_flax`` inverts it bit for bit and loads
    strictly."""
    jmodel = j_build(JConfigDict(_config(name)))
    x = jnp.zeros((B, N, 3), jnp.float32)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "mask", "droppath"))}
    shapes = jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32),
                                    jax.eval_shape(lambda: jmodel.init(rngs, x, x, train=False)))
    model = _port(name)
    sd = model.state_dict()
    p, s = to_flax(sd)
    flat = lambda tree: {k: np.shape(v) for k, v in _flatten(tree).items()}  # noqa: E731
    assert flat(p) == flat(shapes["params"])
    assert flat(s) == flat(shapes["batch_stats"])
    back = from_flax(p, s)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back, strict=True)


def test_point_mae_checkpoint_fills_the_maskfeat_teacher():
    """A ``Point_MAE`` state dict through ``_teacher_state`` (the
    ``teacher_ckpt`` / ``pointmae_config.ckpt`` merge of ``run_pretrain``)
    lands on every tensor of ``MaskFeat_transformer``'s teacher, BatchNorm
    statistics included, and on nothing else."""
    src = _port("Point_MAE", seed=5).state_dict()
    model = _port("MaskFeat_transformer")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    misses = merge_pretrained(model, _teacher_state(src))
    own = model.state_dict()
    teacher = [k for k in own if k.startswith("teacher.")]
    assert len(teacher) > 20
    for k in teacher:
        assert torch.equal(own[k], src["MAE_encoder." + k[len("teacher."):]]), k
    assert all(torch.equal(own[k], before[k]) for k in own if not k.startswith("teacher."))
    assert all(not k.startswith("teacher.MAE_encoder") for k in misses)
    assert not model.teacher.training and not model.train().teacher.training
