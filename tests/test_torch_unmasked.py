"""The unmasked flagship (no ``Drop-Patch`` in ``model.corrupt_type``: every
token through ``NormalTransformerEncoder``, no mask token, every patch in
the loss) of the PyTorch port against the JAX package on the CPU, at
``_tiny_config`` widths in f32, with the shipped unmasked configs' patch
corruption ``['add_local']``: one whole train step (the same raw batch,
initial weights carried by the weight bridge, the pipeline's and the patch
corruption's draws replayed from the JAX keys, the stochastic-depth masks
fed to the JAX model through monkeypatch), ``encode()``, and the weight
bridge both ways. Tolerances: ``test_torch_flagship.py``'s f32 step."""
import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_draws as jd
import test_torch_flagship as tf
from __graft_entry__ import _tiny_config
from point_dae_tpu.engine.pretrain import (init_model as j_init_model,
                                           make_train_step as j_make_train_step)
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict
from point_dae_tpu.utils.convert_torch import convert_state_dict

from point_dae_torch.engine.pretrain import StepDraws, make_train_step
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models import transformer as ttr
from point_dae_torch.models.transformer import ModelDraws, NormalTransformerEncoder
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, NRAW, STEPS_PER_EPOCH = 4, 256, 10
TYPES = ("add_local",)
K_CORRUPT = jax.random.key(5)


def _config():
    cfg = _tiny_config()
    cfg["model"]["corrupt_type"] = list(TYPES)
    del cfg["model"]["transformer_config"]["dtype"]
    return cfg


def _j_init(cfg, raw):
    config = JConfigDict(copy.deepcopy(cfg))
    model = j_build(config["model"])
    params, stats = j_init_model(model, config, jnp.asarray(raw))
    return config, model, params, stats


# Every ReLU of the step sits behind one of these outputs (the patch
# encoder's two BatchNorms, coarse_pred's hidden layers, each folding
# stage's two hidden layers) and each of the patch encoder's two maxima
# over a patch behind the conv2 / conv4 output: (JAX name, the port's module).
def _gate_sites(tmodel):
    enc = tmodel.MAE_encoder.encoder
    return {"encoder/bn1": enc.first_conv[1], "encoder/bn2": enc.second_conv[1],
            "coarse_pred/dense0": tmodel.coarse_pred[0],
            "coarse_pred/dense1": tmodel.coarse_pred[2],
            "folding1/h0": tmodel.folding1[0], "folding1/h1": tmodel.folding1[2],
            "folding2/h0": tmodel.folding2[0], "folding2/h1": tmodel.folding2[2]}


_MAX_SITES = ("encoder/conv2", "encoder/conv4")


def _record_jax_sites(monkeypatch):
    """Record, on the host, the JAX step's value at every gate and max site
    (``jax.debug.callback`` at trace time: the module outputs through
    ``nn.intercept_methods``, each folding stage's hiddens through the
    ``nn.relu`` calls of ``_split_mlp_apply``), the folding head's output
    and the cotangent that reaches it from the loss. Returns (the records,
    the interceptor to run the step under)."""
    seen = {}

    def store(name):
        return lambda x: seen.setdefault(name, []).append(np.asarray(x))

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = "/".join(str(p) for p in context.module.scope.path[-2:])
        if context.method_name == "__call__" and (path in _MAX_SITES or path in (
                "encoder/bn1", "encoder/bn2", "coarse_pred/dense0", "coarse_pred/dense1")):
            jax.debug.callback(store(path), out)
        return out

    @jax.custom_vjp
    def cotangent_probe(x):
        return x

    def probe_bwd(_, g):
        jax.debug.callback(store("folding2/cotangent"), g)
        return (g,)

    cotangent_probe.defvjp(lambda x: (x, None), probe_bwd)
    real_split, real_relu, stages = jtr._split_mlp_apply, nn.relu, iter((1, 2))

    def split(params, shared, per_point, dtype):
        stage, hidden = next(stages), iter((0, 1))

        def relu(x):
            jax.debug.callback(store(f"folding{stage}/h{next(hidden)}"), x)
            return real_relu(x)

        monkeypatch.setattr(nn, "relu", relu)
        try:
            out = real_split(params, shared, per_point, dtype)
        finally:
            monkeypatch.setattr(nn, "relu", real_relu)
        if stage == 2:
            jax.debug.callback(store("folding2/out"), out)
            out = cotangent_probe(out)
        return out

    monkeypatch.setattr(jtr, "_split_mlp_apply", split)
    return seen, interceptor


def _impose_jax_gates(tmodel, seen):
    """Forward hooks on the port's gate sites: where the port's value and
    the JAX one lie on other sides of zero, the port takes the JAX value
    (the gradient still flows through it). Returns {site: (the port's
    values at the flips, the JAX ones, the site's largest gap)}."""
    flips = {}

    def hook(name):
        def fn(mod, inputs, out):
            (want,) = seen[name]
            j = torch.from_numpy(want).reshape(out.shape)
            t = out.detach()
            flip = (t > 0) != (j > 0)
            flips[name] = (t[flip], j[flip], float((t - j).abs().max()))
            return out + torch.where(flip, j - t, 0.0)
        return fn

    return flips, [m.register_forward_hook(hook(n)) for n, m in _gate_sites(tmodel).items()]


def _impose_jax_chamfer_rows(tmodel, seen, monkeypatch):
    """A hook on the port's folding head output whose backward takes the
    JAX cotangent on the rows where the two differ beyond 1e-4 of the
    largest (a nearest-neighbour choice of the local chamfer taken the
    other way; elsewhere they agree to about 1e-6), and a wrapper of the
    local chamfer that keeps its ground-truth patches. Returns (the record
    {"gt", "rows"}, the hook's handle)."""
    rec = {}
    real = ttr.masked_chamfer_l2

    def chamfer(pred, gt, w):
        rec["gt"] = gt.detach()
        return real(pred, gt, w)

    monkeypatch.setattr(ttr, "masked_chamfer_l2", chamfer)

    def hook(mod, inputs, out):
        def swap(g):
            j = torch.from_numpy(seen["folding2/cotangent"][0]).reshape(g.shape)
            rows = (g - j).abs().amax(-1, keepdim=True) > 1e-4 * j.abs().max()
            rec["rows"] = rows.reshape(-1).nonzero().ravel()
            return torch.where(rows, j, g)
        out.register_hook(swap)

    return rec, tmodel.folding2.register_forward_hook(hook)


def _chamfer_near_tie(pred, gt, row, gap) -> bool:
    """Whether predicted point ``row`` of the flattened (B G, 36, 3)
    ``pred`` sits at a nearest-neighbour near-tie of its patch: its two
    nearest ground-truth points, or a ground-truth point's two nearest
    predicted points with ``row`` among them, lie within 2 ``gap`` of
    each other in distance, so that moving every predicted point by at
    most ``gap`` (the two forwards' largest difference) can swap them."""
    patch, p = divmod(int(row), pred.shape[1])
    d = torch.cdist(gt[patch].double(), pred[patch].double())      # (S, 36)
    two = d[:, p].topk(2, largest=False).values
    if two[1] - two[0] <= 2 * gap:
        return True
    vals, idx = d.topk(2, dim=1, largest=False)
    near = (idx == p).any(1) & (vals[:, 1] - vals[:, 0] <= 2 * gap)
    return bool(near.any())


def test_unmasked_train_step_f32_matches_jax(monkeypatch):
    """Losses to 1e-4, running statistics to 1e-4 / 1e-6 and every updated
    parameter to rtol 2e-3 / atol 5e-4 (``test_torch_flagship.py``'s f32
    step; its null-gradient biases to Adam's bound), once the few discrete
    choices that lie within rounding of a tie are taken the JAX way. All 16
    tokens a cloud reach the loss here, and this batch meets two kinds:

    - a ReLU whose input lies within rounding of zero (read: one of bn2's
      262144 inputs, +4.8e-7 in the port and -2.4e-7 in JAX, and one of
      folding1's second hiddens);
    - a nearest neighbour of the local chamfer at a near-tie (read: two
      predicted points of one patch), which sends a row's gradient to
      another point.

    Each moves the gradients by about 1e-3 of their largest, and Adam's
    first step, lr g / (|g| + 1e-8), turns the gradients near zero that
    this moves into steps of lr the other way (left alone: 57 elements of
    the transformer blocks, 101 of conv3 miss). The witness: the JAX step's
    value at every ReLU input, at the patch encoder's two maxima and at the
    folding head's output, and the cotangent that reaches that output, are
    read on the host. The port takes the JAX side only where the two part:
    at a gate whose values lie, on both sides, within the two forwards' own
    gap of zero (at most 1e-4, read 1.7e-5), and on a row of the folding
    output whose cotangent differs beyond 1e-4 of the largest, which must
    be a chamfer near-tie (``_chamfer_near_tie`` at the forwards' gap there,
    read 1.2e-6); at most 8 of each; the maxima must pick the same rows.
    A planted fault (one patch's loss weight 0.99) moves 58 rows."""
    cfg = _config()
    rng = np.random.default_rng(7)
    raw = rng.normal(size=(B, NRAW, 6)).astype(np.float32)
    depth = cfg["model"]["transformer_config"]["depth"]
    dp_enc = rng.uniform(size=(depth, 2, B)) >= 0.3
    dp_enc[-1, :, 0] = False
    dp_enc[-1, :, 1] = True
    G, S = cfg["model"]["num_group"], cfg["model"]["group_size"]

    real = jtr.corrupt_patches

    def corrupt(key_, neigh, center, types, fix_translate_bug=False):
        assert tuple(types) == TYPES
        return real(K_CORRUPT, neigh, center, types)

    monkeypatch.setattr(jtr, "corrupt_patches", corrupt)
    monkeypatch.setattr(jtr, "sample_patch_mask", None)      # unmasked: never drawn

    def dp_masks(mod, dpr, batch, deterministic):
        if deterministic or max(dpr) == 0.0:
            return None
        assert len(dpr) == depth
        return jnp.asarray(dp_enc)

    monkeypatch.setattr(jlayers, "_stack_dp_masks", dp_masks)
    config, model, params, stats = _j_init(cfg, raw)
    assert "mask_token" not in params and "MAE_encoder" in params
    tx, _ = j_build_optimizer(config, params, steps_per_epoch=STEPS_PER_EPOCH)
    state = JTrainState.create(model.apply, params, stats, tx)
    init = jax.device_get((state.params, state.batch_stats))
    key = jax.random.key(11)
    seen, interceptor = _record_jax_sites(monkeypatch)
    with nn.intercept_methods(interceptor):
        state, jm = j_make_train_step(model, config, mesh=None)(
            state, jnp.asarray(raw), key, jnp.float32(0.0))
        jp, js = (_flatten(jax.tree_util.tree_map(np.asarray, t))
                  for t in jax.device_get((state.params, state.batch_stats)))

    tconfig = ConfigDict(copy.deepcopy(cfg))
    tmodel = build_model_from_cfg(tconfig["model"], device="cpu")
    assert not hasattr(tmodel, "mask_token")
    assert set(seen) == set(_gate_sites(tmodel)) | set(_MAX_SITES) | {
        "folding2/out", "folding2/cotangent"}, seen.keys()
    assert all(len(v) == 1 for v in seen.values())
    assert isinstance(tmodel.MAE_encoder, NormalTransformerEncoder)
    tmodel.load_state_dict(from_flax(*init), strict=True)
    flips, handles = _impose_jax_gates(tmodel, seen)
    swapped, handle = _impose_jax_chamfer_rows(tmodel, seen, monkeypatch)
    handles.append(handle)
    fold = {}
    handles.append(tmodel.folding2.register_forward_hook(
        lambda m, i, out: fold.__setitem__("pred", out.detach())))
    enc = tmodel.MAE_encoder.encoder
    maxima = {}
    for name, mod in zip(_MAX_SITES, (enc.first_conv[3], enc.second_conv[3])):
        handles.append(mod.register_forward_hook(
            lambda m, i, out, name=name: maxima.__setitem__(name, out.detach().argmax(1))))
    tstate = TrainState.create(tmodel, tconfig, steps_per_epoch=STEPS_PER_EPOCH)
    d = cfg["dataset"]["train"]["others"]
    draws = StepDraws(
        jd.pipeline_draws(key, raw, d["aug_type"], d["corrupt_type"], d["npoints"]),
        ModelDraws(None, jd.patch_draws(K_CORRUPT, TYPES, (B, G, S)),
                   torch.from_numpy(dp_enc), None))
    tm = make_train_step(tmodel, tconfig, device="cpu")(
        tstate, torch.from_numpy(raw), draws=draws)
    for h in handles:
        h.remove()

    for name, (t, j, gap) in flips.items():
        assert gap <= 1e-4, (name, gap)
        assert (t.abs() <= gap).all() and (j.abs() <= gap).all(), (name, t, j, gap)
    assert sum(len(t) for t, _, _ in flips.values()) <= 8, flips    # of 925,696
    for name, got in maxima.items():
        assert torch.equal(got, torch.from_numpy(seen[name][0].argmax(1))), name
    pred = fold["pred"].reshape(-1, fold["pred"].shape[-2], 3)
    gap = float((pred - torch.from_numpy(seen["folding2/out"][0]).reshape(pred.shape)).abs().max())
    assert gap <= 1e-4 and len(swapped["rows"]) <= 8, (gap, swapped["rows"])
    for row in swapped["rows"]:
        assert _chamfer_near_tie(pred, swapped["gt"], row, gap), int(row)

    tp, ts = (_flatten(t) for t in to_flax(tmodel.state_dict()))
    assert set(jp) == set(tp) and set(js) == set(ts)
    for k in ("loss_xyz", "loss_normal"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    moved = _flatten(jax.tree_util.tree_map(np.asarray, init[0]))
    assert any(not np.array_equal(moved[k], jp[k]) for k in jp)
    for k in sorted(set(jp) - set(tf._NULL_GRAD)):
        np.testing.assert_allclose(tp[k], jp[k], rtol=2e-3, atol=5e-4, err_msg=f"param {k}")
    tf._check_null_grad_params(moved, jp, tp)
    tf._check_stats(js, ts)


def test_unmasked_encode_and_weight_bridge():
    """``encode()`` (eval mode, max + mean over every token) against the
    JAX model's ``encode``; the JAX init tree -> port state_dict (loads
    strictly) -> JAX tree exactly; and ``to_flax`` of the port's state_dict
    against the JAX package's ``convert_state_dict``."""
    cfg = _config()
    pts = np.random.default_rng(1).normal(size=(B, 128, 3)).astype(np.float32)
    config, model, params, stats = _j_init(cfg, pts)
    want = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x,
                                               method=model.encode))(params, stats, pts)
    params, stats = jax.device_get((params, stats))
    sd = from_flax(params, stats)
    port = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg))["model"], device="cpu")
    port.load_state_dict(sd, strict=True)
    port.eval()
    with torch.no_grad():
        got = port.encode(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    p2, s2 = to_flax(port.state_dict())
    for a, b in ((_flatten(params), _flatten(p2)), (_flatten(stats), _flatten(s2))):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    flat = {k: v.numpy() for k, v in port.state_dict().items()}
    stripped = {k[len("MAE_encoder."):] if k.startswith("MAE_encoder.") else k: v
                for k, v in flat.items()}
    enc_tops = ("encoder/", "pos_embed/", "blocks/", "norm/")
    ref = {("MAE_encoder/" + k if k.startswith(enc_tops) else k): v
           for k, v in convert_state_dict(stripped, "transformer").items()}
    got_tree = {**_flatten(p2), **_flatten(s2)}
    assert set(got_tree) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got_tree[k], ref[k], err_msg=k)


@pytest.mark.parametrize("types", [("add_local",), ("jitter", "scan"),
                                   ("affine_r3", "dropout_global", "rotate_z")])
def test_unmasked_model_draws_no_mask(types):
    """In unmasked mode the draws hold no patch mask, the loss weights are
    all ones and nothing is packed; a masked twin of the same config
    (``Drop-Patch`` added) still draws its mask and has its mask token."""
    cfg = _config()
    cfg["model"]["corrupt_type"] = list(types)
    model = build_model_from_cfg(ConfigDict(cfg)["model"], device="cpu")
    g = torch.Generator().manual_seed(0)
    draws = model.sample_draws(B, g, "cpu")
    assert draws.mask is None and len(draws.corrupt) == len(types)
    mask = torch.zeros((B, cfg["model"]["num_group"]), dtype=torch.bool)
    assert model._masked_pack_idx(mask) is None
    assert torch.equal(model._loss_weights(mask), torch.ones(mask.numel()))
    cfg["model"]["corrupt_type"] = list(types) + ["Drop-Patch"]
    masked = build_model_from_cfg(ConfigDict(cfg)["model"], device="cpu")
    assert masked.sample_draws(B, g, "cpu").mask.shape == mask.shape
    assert hasattr(masked, "mask_token")
