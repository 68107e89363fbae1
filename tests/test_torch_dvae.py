"""The dVAE tokenizer and the MaskSurf losses of the port against the JAX
package on the CPU, and the ``model.dvae_config.ckpt`` merge.

At a tiny width (64 tokens, encoder 32, codebook and decoder 16 wide, G
16 x S 8 of 128 points, B 2) with the port's initial weights carried to
JAX through ``to_flax`` (BatchNorm running statistics set away from (0,
1)): ``tokenize`` and ``decode_tokens`` in eval mode; ``Point_dVAE``'s two
loss parts and the gradient of their sum in training mode with the same
Gumbel noise (``jax.random.gumbel`` monkeypatched), with ``hard`` False
and True; ``chamfer_l1``, ``masked_chamfer_l1`` and
``masked_chamfer_l2_withnormal`` (each normal distance) with their
gradients. The merge loads ``.pth`` files made in ``tmp_path``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.losses import chamfer as jch
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.engine.pretrain import merge_dvae_teacher
from point_dae_torch.losses import chamfer as tch
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

B, N, G, S, V = 2, 128, 16, 8, 64
DVAE = {"NAME": "Point_dVAE", "corrupt_type": [], "group_size": S, "num_group": G,
        "num_tokens": V, "encoder_dims": 32, "tokens_dims": 16, "decoder_dims": 16,
        "temperature": 0.7}


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port(cfg):
    """The port's model at its initial weights, its BatchNorm running
    statistics set away from (0, 1), and the flax tree of its state."""
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg)), device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, buf.shape)))
    return model, to_flax(model.state_dict())


def _clouds(seed):
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


def _close(got, want, what):
    """Within 1e-5 of the tensor's largest magnitude (f32 sums in another
    order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=what)


def test_tokenize_and_decode_tokens_match_jax():
    """Eval mode (running statistics): the logits (B, G, V), the
    neighbourhoods and centres within 1e-5 of their largest value, the
    argmax tokens equal; those tokens through ``decode_tokens``: coarse and
    fine patches within 1e-5."""
    model, (params, stats) = _port(DVAE)
    model.eval()
    pts = _clouds(1)
    jm = j_build(JConfigDict(copy.deepcopy(DVAE)))
    variables = {"params": params, "batch_stats": stats}

    def run(p):
        logits, neigh, center = jm.apply(variables, p, method=lambda m, x: m.dvae.tokenize(
            x, train=False))
        ids = jnp.argmax(logits, -1)
        return (logits, neigh, center, ids) + jm.apply(
            variables, ids, center, method=lambda m, i, c: m.dvae.decode_tokens(i, c))

    want = _tree(jax.jit(run)(jnp.asarray(pts)))
    with torch.no_grad():
        logits, neigh, center = model.dvae.tokenize(torch.from_numpy(pts))
        ids = logits.argmax(-1)
        coarse, fine = model.dvae.decode_tokens(ids, center)
    assert coarse.shape == (B, G, S // 4, 3) and fine.shape == (B, G, S, 3)
    for got, w, what in zip((logits, neigh, center), want[:3], ("logits", "neigh", "center")):
        _close(got.numpy(), w, what)
    assert np.array_equal(ids.numpy(), want[3])
    _close(coarse.numpy(), want[4], "coarse")
    _close(fine.numpy(), want[5], "fine")


@pytest.mark.parametrize("hard", [False, True])
def test_point_dvae_loss_parts_and_grads_match_jax(monkeypatch, hard):
    """Training mode with the same Gumbel noise: the reconstruction chamfer
    and the KL within 1e-5 relative; the gradient of their sum within 1e-4
    of each tensor's largest magnitude, or 1e-6 of the model's largest
    where the tensor's own is rounding noise (a bias followed by
    BatchNorm); every running statistic after the forward within 1e-5. The
    straight-through one-hot (``hard``) passes the soft gradient. With
    ``hard`` two patches of one token carry one codebook row, up to the
    rounding of (1 + y) - y, and the dgcnn_2 max-pools then pick between
    edges equal but for that rounding, in each package its own way: the
    reference's gradient itself is not defined there. So the hard case's
    noise gives each patch of a cloud its own token (10 added at a
    distinct token a patch)."""
    cfg = dict(DVAE, hard=str(hard))
    model, (params, stats) = _port(cfg)
    pts = _clouds(2)
    rng = np.random.default_rng(3)
    gumbel = -np.log(-np.log(rng.uniform(1e-6, 1.0, size=(B, G, V))))
    if hard:
        for b in range(B):
            gumbel[b, np.arange(G), rng.permutation(V)[:G]] += 10.0
    gumbel = gumbel.astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(gumbel))
    jm = j_build(JConfigDict(copy.deepcopy(cfg)))

    def loss_fn(p, x):
        (rec, kl), new = jm.apply({"params": p, "batch_stats": stats}, x, x, train=True,
                                  rngs={"mask": jax.random.key(0)}, mutable=["batch_stats"])
        return rec + kl, (rec, kl, new["batch_stats"])

    (_, (rec_j, kl_j, stats_j)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(pts))
    model.train()
    t = torch.from_numpy(pts)
    rec, kl = model(t, t, draws=torch.from_numpy(gumbel))
    (rec + kl).backward()
    if hard:
        tokens = copy.deepcopy(model).dvae.tokenize(t)[0].detach() + torch.from_numpy(gumbel)
        assert all(len(set(r.tolist())) == G for r in tokens.argmax(-1))
    np.testing.assert_allclose([float(rec.detach()), float(kl.detach())],
                               [float(rec_j), float(kl_j)], rtol=1e-5)
    grads_j = _flatten(_tree(grads))
    grads_t = _flatten(to_flax({n: p.grad for n, p in model.named_parameters()})[0])
    assert set(grads_t) == set(grads_j)
    top = max(np.abs(g).max() for g in grads_j.values())
    for k in sorted(grads_j):
        g = grads_j[k]
        np.testing.assert_allclose(grads_t[k], g, rtol=0,
                                   atol=max(1e-4 * np.abs(g).max(), 1e-6 * top), err_msg=k)
    stats_t = _flatten(to_flax(model.state_dict())[1])
    for k, v in _flatten(_tree(stats_j)).items():
        _close(stats_t[k], v, k)


def _sets(seed, P=6, n=8, m=10):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(P, n, 3), f(P, m, 3), f(P, n, 3), f(P, m, 3), \
        (rng.uniform(size=P) < 0.6).astype(np.float32)


def _compare_loss(jfn, tfn, args, n_grad):
    """The loss within 1e-5 relative; the gradient of each of the first
    ``n_grad`` arguments within 1e-5 of its largest magnitude."""
    jargs = [jnp.asarray(a) for a in args]
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(jnp.stack(jfn(*a))), argnums=tuple(range(n_grad))))(*jargs)
    targs = [torch.tensor(a, requires_grad=i < n_grad) for i, a in enumerate(args)]
    got = tfn(*targs)
    got = torch.stack(got).sum() if isinstance(got, tuple) else got
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for i, w in enumerate(wgrads):
        _close(targs[i].grad.numpy(), np.asarray(w), f"grad {i}")


def test_chamfer_l1_matches_jax():
    x, y, _, _, _ = _sets(7)
    _compare_loss(lambda a, b: (jch.chamfer_l1(a, b),), tch.chamfer_l1, (x, y), 2)


def test_masked_chamfer_l1_matches_jax():
    x, y, _, _, w = _sets(8)
    _compare_loss(lambda a, b, c: (jch.masked_chamfer_l1(a, b, c),), tch.masked_chamfer_l1,
                  (x, y, w), 2)


@pytest.mark.parametrize("dis", ["dis_normalized_l2", "dis_normalized_l1",
                                 "dis_normalized_l2_strict"])
def test_masked_chamfer_l2_withnormal_matches_jax(dis):
    """Both terms (summed for the gradient) with the normals paired through
    the xyz correspondence; gradients of points and normals of both sets."""
    x, y, nx, ny, w = _sets(9)
    _compare_loss(
        lambda a, b, c, d, e: jch.masked_chamfer_l2_withnormal(a, b, c, d, e,
                                                               getattr(jch, dis)),
        lambda a, b, c, d, e: tch.masked_chamfer_l2_withnormal(a, b, c, d, e,
                                                               getattr(tch, dis)),
        (x, y, nx, ny, w), 4)


TOKENDIS = {"NAME": "MaskSurf_v2_token_dis", "corrupt_type": ["clean"], "group_size": S,
            "num_group": G, "dvae_config": {k: DVAE[k] for k in (
                "num_tokens", "encoder_dims", "tokens_dims", "decoder_dims")},
            "transformer_config": {"mask_ratio": 0.6, "trans_dim": 32, "encoder_dims": 32,
                                   "depth": 1, "num_heads": 2, "decoder_depth": 1,
                                   "decoder_num_heads": 2}}


def _conv_layout(k: str, v: torch.Tensor) -> torch.Tensor:
    """A port dense weight in Point-BERT's layout: Conv2d (out, in, 1, 1) in
    the EdgeConv layers, Conv1d (out, in, 1) in the other 1x1 convolutions,
    Linear (out, in) in the decoder's MLP."""
    if not k.endswith(".weight") or v.dim() != 2 or ".mlp." in k:
        return v
    edge = any(f".layer{i}.0." in k for i in range(1, 5))
    return v[:, :, None, None] if edge else v[:, :, None]


def test_dvae_ckpt_merges_point_bert_and_port_files_and_refuses_others(tmp_path):
    """A Point-BERT-named ``dVAE.pth`` (``module.`` prefixed, convolution
    weights with their unit axes, ``num_batches_tracked`` entries) and a
    port ``Point_dVAE`` checkpoint both fill every tokenizer tensor of
    token_dis (parameters and running statistics), leaving the student as
    it was; the names of the decoder side (``dgcnn_2``, ``decoder``), which
    the tokenizer does not hold, come back unmatched. A file that names no
    tokenizer parameter raises."""
    dvae, _ = _port(DVAE)
    src = {k[len("dvae."):]: v for k, v in dvae.state_dict().items()}
    pb = {f"module.{k}": _conv_layout(k, v) for k, v in src.items()}
    pb.update({f"module.{k[:-len('running_mean')]}num_batches_tracked": torch.tensor(7)
               for k in src if k.endswith("running_mean")})
    torch.save({"base_model": pb}, tmp_path / "dVAE.pth")
    torch.save({"base_model": dvae.state_dict(), "step": 3}, tmp_path / "ckpt-last.pth")
    torch.save({"base_model": {"encoder.conv9.weight": torch.zeros(2, 2)}},
               tmp_path / "other.pth")
    for path in ("dVAE.pth", "ckpt-last.pth"):
        model = build_model_from_cfg(ConfigDict(copy.deepcopy(TOKENDIS)), device="cpu")
        student = {k: v.clone() for k, v in model.state_dict().items()
                   if not k.startswith("dvae_teacher.")}
        misses = merge_dvae_teacher(model, str(tmp_path / path))
        sd = model.state_dict()
        teacher = [k for k in sd if k.startswith("dvae_teacher.")]
        assert teacher and all(torch.equal(sd[k], src[k[len("dvae_teacher."):]])
                               for k in teacher)
        assert all(torch.equal(sd[k], v) for k, v in student.items())
        side = {m.split(".")[1] for m in misses if not m.endswith("num_batches_tracked")}
        assert side == {"dgcnn_2", "decoder"}, misses
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(TOKENDIS)), device="cpu")
    with pytest.raises(ValueError, match="matched 0 of the dvae_teacher"):
        merge_dvae_teacher(model, str(tmp_path / "other.pth"))


def test_dvae_weights_carry_across_both_ways():
    """A Point_dVAE state dict -> flax tree -> state dict is the identity,
    and the tree has the JAX model's paths and shapes."""
    model, (p, s) = _port(DVAE)
    jm = j_build(JConfigDict(copy.deepcopy(DVAE)))
    x = jnp.zeros((B, N, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0),
                                             "mask": jax.random.key(1)}, x, x, train=True))
    shapes = jax.tree_util.tree_map(lambda v: np.empty(v.shape, np.float32), shapes)
    flat = lambda tree: {k: np.shape(v) for k, v in _flatten(tree).items()}
    assert flat(p) == flat(shapes["params"]) and flat(s) == flat(shapes["batch_stats"])
    sd = model.state_dict()
    back = from_flax(p, s)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
