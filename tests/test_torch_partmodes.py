"""The optimizer's part modes (``only_new``, ``diff_lr``, ``decoder``, and
``all`` with a frozen teacher) against the JAX package's
``build_optimizer`` on the CPU, and the ``only_new`` fine-tune step with
its BatchNorms in eval mode against the JAX step, for one step and for
three with a clip that binds by a small factor (each step clipping its own
gradients, the frozen ones included).

One AdamW step from the same weights (the port's initial ones through
``to_flax``) and the same gradients (numpy, seeded) on both sides, for
a class of each mode at tiny widths (every class's labels are held by
``test_part_labels_name_the_jax_paths``, the linear probe's ``only_new``
by its whole step). The clip (10) binds: the frozen or pretrained leaves get
gradients 1e7 times larger, so the global norm (about 1e9) is theirs and
pushes the trained leaves' clipped gradients near Adam's eps (1e-8),
where the update lr * g / (|g| + eps) follows the norm and not only the
sign. A norm that left the frozen leaves out would move them by lr."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from point_dae_tpu.engine import finetune as jft
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.engine import finetune as tft
from point_dae_torch.engine.train_state import TrainState, build_optimizer, part_label
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, flax_paths, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

LR, CLIP, BIG = 1e-2, 10.0, 1e7
STEPS_CLIP = 5.0
_TF = {"trans_dim": 32, "encoder_dims": 32, "depth": 1, "num_heads": 2, "drop_path_rate": 0.1,
       "group_size": 8, "num_group": 16, "cls_dim": 5}
_PRE = {"group_size": 8, "num_group": 16, "loss": "cdl2",
        "transformer_config": {"rand_ratio": "False", "mask_ratio": 0.6, "mask_type": "rand",
                               "trans_dim": 32, "encoder_dims": 32, "depth": 1,
                               "drop_path_rate": 0.1, "num_heads": 2, "decoder_depth": 1,
                               "decoder_num_heads": 2}}
MODELS = {"PointTransformer": _TF, "PointTransformer_LinearClassification": _TF,
          "PointNetv2": {"cls_dim": 5}, "PointNetv2_Linear": {"cls_dim": 5},
          "PointCAE_transformer_fc_global_fc_local_3detr": _PRE, "Point_MAE": _PRE,
          "MaskFeat_transformer": _PRE}
HEADS = {"PointCAE_transformer_fc_global_fc_local_3detr": 2}
CASES = [("PointTransformer", "only_new"), ("PointTransformer", "diff_lr"),
         ("PointCAE_transformer_fc_global_fc_local_3detr", "decoder"),
         ("MaskFeat_transformer", "all")]


def _config(name, part, clip=CLIP):
    return {"optimizer": {"type": "AdamW", "part": part,
                          "kwargs": {"lr": LR, "weight_decay": 0.05}},
            "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
            "model": dict(copy.deepcopy(MODELS[name]), NAME=name), "npoints": 256,
            "total_bs": 4, "max_epoch": 300, "grad_norm_clip": clip}


def _port(name):
    return build_model_from_cfg(ConfigDict(dict(copy.deepcopy(MODELS[name]), NAME=name)),
                                device="cpu")


def _is_big(part, path):
    """The leaves whose gradients carry the norm: the frozen or pretrained
    ones, or under ``all`` the student encoder's."""
    if part == "all":
        return path.startswith("MAE_encoder/")
    return part_label(part, path) != "train"


@pytest.mark.parametrize("name,part", CASES)
def test_adamw_step_of_part_mode_matches_jax(name, part):
    """Frozen leaves (the teacher under ``all``) unchanged on both sides,
    bit for bit; every trained leaf's step within 1e-3 relative of JAX's
    (f32 rounding of the norm and of p - update); the same set of leaves
    moves on both sides; under ``diff_lr`` the pretrained leaves move by at
    most 0.1 lr (plus their decay) and the new ones by more."""
    model = _port(name)
    heads = HEADS.get(name)
    params, _ = to_flax(model.state_dict(), num_heads=heads)
    old = _flatten(params)
    paths = flax_paths([n for n, _ in model.named_parameters()])
    rng = np.random.default_rng(3)
    grads = {}
    for n, p in model.named_parameters():
        g = rng.normal(size=tuple(p.shape)).astype(np.float32)
        if "teacher" in n:
            g[...] = 0.0                     # the JAX teacher's stop-gradient
        elif _is_big(part, paths[n]):
            g *= BIG
        grads[n] = torch.from_numpy(g)
    jgrads = to_flax(grads, num_heads=heads)[0]
    assert float(optax.global_norm(jgrads)) > 1e3 * CLIP

    cfg = _config(name, part)
    tx, _ = j_build_optimizer(JConfigDict(copy.deepcopy(cfg)), params, 10, CLIP)
    jnew = _flatten(jax.device_get(jax.jit(  # one compile: init, update and apply
        lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(jgrads, params)))

    state = TrainState.create(model, ConfigDict(copy.deepcopy(cfg)), 10, CLIP)
    for n, p in model.named_parameters():
        p.grad = None if "teacher" in n else grads[n].clone()
    state.apply_gradients()
    tnew = _flatten(to_flax(model.state_dict(), num_heads=heads)[0])

    assert set(tnew) == set(jnew) == set(old)
    moved = set()
    for k in sorted(old):
        dj, dt = jnew[k] - old[k], tnew[k] - old[k]
        if not dj.any():
            assert not dt.any(), k
            continue
        moved.add(k)
        np.testing.assert_allclose(dt, dj, rtol=1e-3, atol=1e-6, err_msg=k)
    frozen = set(old) - moved
    assert moved and (frozen if part in ("only_new", "decoder") else True)
    if part == "diff_lr":
        assert not frozen
    if part == "all":
        assert frozen == {k for k in old if k.startswith("teacher/")} != set()
    if part == "diff_lr":
        new = [k for k in moved if "cls" in k]
        pre = [k for k in moved if "cls" not in k]
        assert new and pre
        for k in pre:
            bound = 0.1 * LR * (1 + 0.05 * np.abs(old[k])) * (1 + 1e-3)
            assert (np.abs(tnew[k] - old[k]) <= bound).all(), k
        assert max(np.abs(tnew[k] - old[k]).max() for k in new) > 0.2 * LR


@pytest.mark.parametrize("name", sorted(MODELS))
def test_part_labels_name_the_jax_paths(name):
    """Each part mode's AdamW groups hold exactly the parameters whose flax
    path the JAX labels train, and every path ``flax_paths`` gives is a
    leaf or a module of ``to_flax``'s tree; an unknown part raises."""
    model = _port(name)
    flat = set(_flatten(to_flax(model.state_dict(), num_heads=HEADS.get(name))[0]))
    paths = flax_paths([n for n, _ in model.named_parameters()])
    for n, path in paths.items():
        assert path in flat or any(k.startswith(path + "/") for k in flat), (n, path)
    for part in ("all", "only_new", "diff_lr", "decoder"):
        opt, _ = build_optimizer(_config(name, part), model, 10)
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        for n, p in model.named_parameters():
            path = paths[n].lower()
            want = {"all": "teacher" not in path, "only_new": "cls" in path,
                    "diff_lr": True,
                    "decoder": any(k in path for k in ("decoder_pos_embed", "mae_decoder",
                                                       "increase_dim"))}[part]
            assert (id(p) in held) == want, (part, n)
    with pytest.raises(NotImplementedError):
        build_optimizer(_config(name, "encoder"), model, 10)


# ---------------------------------------------- the only_new fine-tune step

B, N = 4, 256


@functools.lru_cache(maxsize=None)
def _linear_case():
    """The linear probe's port model (BatchNorm statistics moved off their
    init values), its flax tree, a batch and the drop-path keep masks."""
    model = _port("PointTransformer_LinearClassification")
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif n.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(B,)).astype(np.int32)
    dp = rng.uniform(size=(1, 2, B)) >= 0.3
    dp[0, :, 0] = False
    return model, to_flax(model.state_dict()), pts, labels, dp


def test_only_new_linear_step_matches_jax(monkeypatch):
    """One f32 step of ``finetune_*_linear_classification`` at a tiny width:
    every BatchNorm normalises by its running statistics, which stay as
    they were, bit for bit; every encoder leaf stays as it was; the ``cls``
    Dense moves as in JAX (2e-3 relative, 1e-6 absolute) and the loss
    agrees within 1e-4 relative. The clip is 1e-7 here: the clipped ``cls``
    gradients sit near Adam's eps, so the true gradients' norm (the frozen
    encoder's included) sets the step."""
    model, (params, stats), pts, labels, dp = _linear_case()
    cfg = _config("PointTransformer_LinearClassification", "only_new", clip=1e-7)
    cfg["smooth"] = False
    monkeypatch.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                        if det or max(dpr) == 0.0 else jnp.asarray(dp))
    jcfg = JConfigDict(copy.deepcopy(cfg))
    jmodel = j_build(JConfigDict(copy.deepcopy(cfg["model"])))
    tx, _ = j_build_optimizer(jcfg, params, 10, jcfg["grad_norm_clip"])
    jstate = JTrainState.create(jmodel.apply, params, stats, tx)
    jstep = jft.make_finetune_step(jmodel, jcfg, None, smooth=False)
    jstate, jm = jstep(jstate, jnp.asarray(pts), jnp.asarray(labels), jax.random.key(1))
    jp, js = (_flatten(jax.device_get(t)) for t in (jstate.params, jstate.batch_stats))

    state = TrainState.create(model, ConfigDict(copy.deepcopy(cfg)), 10, cfg["grad_norm_clip"])
    step = tft.make_finetune_step(model, ConfigDict(copy.deepcopy(cfg)), device="cpu")
    m = step(state, torch.from_numpy(pts), torch.from_numpy(labels),
             draws=tft.FinetuneDraws(model=ClsDraws([], torch.from_numpy(dp))))
    tp, ts = (_flatten(t) for t in to_flax(model.state_dict()))
    old_p, old_s = _flatten(params), _flatten(stats)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    for k in old_s:
        assert np.array_equal(ts[k], old_s[k]) and np.array_equal(np.asarray(js[k]), old_s[k]), k
    for k in old_p:
        if k.startswith("cls/"):
            assert np.abs(tp[k] - old_p[k]).max() > 0, k
            np.testing.assert_allclose(tp[k], jp[k], rtol=2e-3, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(tp[k], old_p[k]) and np.array_equal(jp[k], old_p[k]), k
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for n, p in model.named_parameters() if n.startswith("encoder."))
    model.load_state_dict(from_flax(params, stats))


def test_only_new_steps_match_jax_with_each_steps_gradients(monkeypatch):
    """Three f32 ``only_new`` steps of the linear probe with a clip that
    binds by a small factor (each step's global norm, read through the
    port's clip, between 1 and 3 times it): each step's norm is that step's
    gradients alone, the frozen encoder's included, not a sum with the
    clipped gradients of the step before, so every step's ``cls`` update
    follows JAX's. After the third step each ``cls`` leaf's change from its
    initial value within 2e-3 of the largest change of JAX's leaf; the
    encoder and the BatchNorm statistics as they were, bit for bit."""
    from point_dae_torch.engine import train_state as ts_mod

    model, (params, stats), pts, labels, dp = _linear_case()
    cfg = _config("PointTransformer_LinearClassification", "only_new", clip=STEPS_CLIP)
    cfg["smooth"] = False
    monkeypatch.setattr(jlayers, "_stack_dp_masks", lambda mod, dpr, batch, det: None
                        if det or max(dpr) == 0.0 else jnp.asarray(dp))
    norms = []
    clip = ts_mod.clip_by_global_norm_
    monkeypatch.setattr(ts_mod, "clip_by_global_norm_",
                        lambda grads, m, shards=None: norms.append(float(clip(grads, m, shards)))
                        or norms[-1])
    jcfg = JConfigDict(copy.deepcopy(cfg))
    jmodel = j_build(JConfigDict(copy.deepcopy(cfg["model"])))
    tx, _ = j_build_optimizer(jcfg, params, 10, jcfg["grad_norm_clip"])
    jstate = JTrainState.create(jmodel.apply, params, stats, tx)
    jstep = jft.make_finetune_step(jmodel, jcfg, None, smooth=False)
    state = TrainState.create(model, ConfigDict(copy.deepcopy(cfg)), 10, cfg["grad_norm_clip"])
    step = tft.make_finetune_step(model, ConfigDict(copy.deepcopy(cfg)), device="cpu")
    for _ in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(pts), jnp.asarray(labels), jax.random.key(1))
        step(state, torch.from_numpy(pts), torch.from_numpy(labels),
             draws=tft.FinetuneDraws(model=ClsDraws([], torch.from_numpy(dp))))
    assert len(norms) == 3 and all(STEPS_CLIP < n < 3 * STEPS_CLIP for n in norms), norms
    jp = _flatten(jax.device_get(jstate.params))
    tp, tstat = (_flatten(t) for t in to_flax(model.state_dict()))
    old_p, old_s = _flatten(params), _flatten(stats)
    for k in old_s:
        assert np.array_equal(tstat[k], old_s[k]), k
    for k in old_p:
        if k.startswith("cls/"):
            dj, dt = jp[k] - old_p[k], tp[k] - old_p[k]
            np.testing.assert_allclose(dt, dj, rtol=0, atol=2e-3 * np.abs(dj).max(), err_msg=k)
        else:
            assert np.array_equal(tp[k], old_p[k]), k
    model.load_state_dict(from_flax(params, stats))
