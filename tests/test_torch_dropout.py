"""The in-model dropouts of the DGCNN pretrain models and the rank-keyed
gather under them, against the JAX package on the CPU: the key gather's
plain version against ``gather_by_key_small_c_pallas`` in interpret mode
(bit for bit, unmatched draws giving zeros); each dropout of
``models/common.py`` with its draws rebuilt from the JAX keys (points bit
for bit); the masked resample's two layouts on a cloud with no valid
point; and the corrupt-type propagation of ``cli.py:116-125``."""
import argparse
import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu import cli as jcli
from point_dae_tpu import ops as jops
from point_dae_tpu.models import common as jcommon
from point_dae_tpu.ops.pallas_scatter import gather_by_key_small_c_pallas

from point_dae_torch.engine import finetune as pfinetune, partseg as ppartseg
from point_dae_torch.models.common import DropoutDraws, apply_input_dropout, is_input_dropout
from point_dae_torch.ops.gather import gather_by_key_plain
from point_dae_torch.ops.geometry import resample_batch
from point_dae_torch.utils.config import propagate_corrupt_type

from _torch_files import one_torch_thread  # noqa: F401

B, N = 3, 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_key_gather_plain_matches_pallas_interpret():
    """Ranks of a random mask, draws below each row's count and, in row 1,
    draws past it (no key matches: zeros); row 2 has no valid point, so
    every draw comes out as zeros. Bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 256, 3)).astype(np.float32)
    mask = rng.random(size=(B, 256)) > 0.4
    mask[2] = False
    rank = np.cumsum(mask, axis=1) - 1
    keys = np.where(mask, rank, -1).astype(np.int32)
    cnt = np.maximum(mask.sum(1), 1)
    draw = (rng.random(size=(B, 300)) * cnt[:, None]).astype(np.int32)
    draw[1, :20] = cnt[1] + np.arange(20)                    # past the valid count
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gather_by_key_small_c_pallas(jnp.asarray(x), jnp.asarray(keys),
                                                       jnp.asarray(draw), tq=64))
    got = gather_by_key_plain(_t(x), _t(keys), _t(draw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1, :20].any() and not got[2].any() and got[0].any()


def _global_draws(key, mask_n: int):
    """dropout_global's draws from its key: the ranking uniforms and the
    resample ranks below the kept count."""
    k_m, k_rs = jax.random.split(key)
    r = jax.random.uniform(k_m, (B, N))
    draw = jax.random.randint(k_rs, (B, N), 0, jnp.full((B, 1), max(mask_n, 1)))
    return DropoutDraws(resample=_t(draw), rank_u=_t(r))


def _patch_draws(key, pts):
    """dropout_patch_pointmae's draws from its key: the level, the patch
    uniforms and the resample ranks below each cloud's surviving count."""
    k_lv, k_mask, k_rs = jax.random.split(key, 3)
    level = jax.random.uniform(k_lv, (), minval=0.0, maxval=4.0)
    u = jax.random.uniform(k_mask, (64,))
    keep = np.array(u > level / 10.0 + 0.5)
    keep[0] |= not keep.any()
    cnt = jnp.full((B, 1), keep.sum() * 32, jnp.int32)
    draw = jax.random.randint(k_rs, (B, N), 0, cnt)
    return DropoutDraws(resample=_t(draw), level=_t(level), patch_u=_t(u))


def _points(seed):
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


@pytest.mark.parametrize("item", ["dropout_global"] + [f"dropout_global_p{p}"
                                                       for p in range(1, 10)])
def test_dropout_global_matches_jax(item):
    """int(N * (1 - p)) points kept, in Python float arithmetic (p = 3 keeps
    89 of 128, not 90), then resampled back to N: bit for bit."""
    pts = _points(1)
    key = jax.random.key(7)
    p = 0.5 if item == "dropout_global" else int(item[-1]) / 10.0
    keep_n = int(N * (1.0 - p))
    want = np.asarray(jcommon.apply_input_dropout(key, jnp.asarray(pts), [item]))
    got = apply_input_dropout(_t(pts), [item],
                              [_global_draws(jax.random.fold_in(key, 0), keep_n)])
    np.testing.assert_array_equal(got.numpy(), want)
    kept = {tuple(r) for r in got[0].tolist()}
    assert len(kept) <= keep_n


def test_dropout_patch_pointmae_matches_jax():
    """Patchify (64 patches of 32), one patch mask for the batch, the
    survivors resampled back to N: bit for bit, on two keys."""
    pts = _points(2)
    for seed in (3, 4):
        key = jax.random.key(seed)
        want = np.asarray(jcommon.apply_input_dropout(key, jnp.asarray(pts),
                                                      ["dropout_patch_pointmae"]))
        got = apply_input_dropout(_t(pts), ["dropout_patch_pointmae"],
                                  [_patch_draws(jax.random.fold_in(key, 0), pts)])
        np.testing.assert_array_equal(got.numpy(), want)


def test_apply_input_dropout_chain_and_random_dropout_match_jax():
    """A chain as the shipped configs name them: a data-pipeline corruption
    (a no-op here), ``random_dropout`` (both outcomes of its coin over the
    keys tried) and ``dropout_global_p3`` after it, each item's draws from
    ``fold_in(key, i)``."""
    pts = _points(5)
    types = ["affine_r3", "random_dropout", "dropout_global_p3"]
    assert [is_input_dropout(t) for t in types] == [False, True, True]
    coins = set()
    for seed in range(6):
        key = jax.random.key(seed)
        want = np.asarray(jcommon.apply_input_dropout(key, jnp.asarray(pts), types))
        k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
        coin = jax.random.uniform(k1)
        coins.add(bool(coin > 0.5))
        if coin > 0.5:
            d1 = _patch_draws(k2, pts)
        else:
            d1 = _global_draws(k2, int(N * 0.5))
        d1.coin = _t(coin)
        d2 = _global_draws(jax.random.fold_in(key, 2), int(N * (1.0 - 0.3)))
        got = apply_input_dropout(_t(pts), types, [d1, d2])
        np.testing.assert_array_equal(got.numpy(), want)
    assert coins == {True, False}


def test_resample_of_a_cloud_without_valid_points():
    """Inside the gate (the key gather) such a cloud gives zeros, outside it
    (the argsort pack) its first point, in both packages; the other clouds
    agree between the two layouts."""
    pts = _points(6)
    mask = np.random.default_rng(6).random(size=(B, N)) > 0.5
    mask[1] = False
    cnt = np.maximum(mask.sum(1), 1)
    key = jax.random.key(9)
    draw = np.asarray(jax.random.randint(key, (B, 64), 0, jnp.asarray(cnt)[:, None]))
    outside_j = np.asarray(jops.resample_batch(key, jnp.asarray(pts), jnp.asarray(mask), 64))
    keys = np.where(mask, np.cumsum(mask, axis=1) - 1, -1).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        inside_j = np.asarray(gather_by_key_small_c_pallas(
            jnp.asarray(pts), jnp.asarray(keys), jnp.asarray(draw)))
    outside_t = resample_batch(_t(pts), _t(mask), 64, draws=_t(draw)).numpy()
    inside_t = gather_by_key_plain(_t(pts), _t(keys), _t(draw)).numpy()
    np.testing.assert_array_equal(outside_t, outside_j)
    np.testing.assert_array_equal(inside_t, inside_j)
    assert (outside_t[1] == pts[1, 0]).all() and not inside_t[1].any()
    np.testing.assert_array_equal(inside_t[[0, 2]], outside_t[[0, 2]])


_CASES = [  # (model corrupt_type, dataset corrupt_type, run flag)
    (None, ["dropout_patch_pointmae"], None),
    ([], ["dropout_global_p3"], None),
    (["clean"], ["dropout_global"], None),
    (["affine_r3"], None, None),
    (None, None, None),
    (None, ["dropout_patch_pointmae"], "finetune_model"),
    (None, ["dropout_global"], "scratch_model"),
    (None, ["dropout_global"], "test"),
]


@pytest.mark.parametrize("model_ct,ds_ct,flag", _CASES)
def test_corrupt_type_propagation_matches_cli(tmp_path, model_ct, ds_ct, flag):
    """A pretrain run: ``propagate_corrupt_type`` gives the model config
    that the JAX CLI's ``load_config`` gives. A fine-tune, scratch or test
    run: the CLI keeps the model's list, and the port's entries for those
    runs never call the propagation (nor ``init_model``, which applies it)."""
    cfg = {"model": {"NAME": "Point_CAE_DGCNN_FCOnly"},
           "dataset": {"train": {"others": {"npoints": 1024}}}}
    if model_ct is not None:
        cfg["model"]["corrupt_type"] = model_ct
    if ds_ct is not None:
        cfg["dataset"]["train"]["others"]["corrupt_type"] = ds_ct
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    flags = dict(finetune_model=False, scratch_model=False, test=False,
                 test_corruption=False)
    if flag:
        flags[flag] = True
    args = argparse.Namespace(config=str(path), model_name=None, total_bs=0, shot=-1,
                              experiment_path=str(tmp_path / "exp"), **flags)
    want = jcli.load_config(args)["model"].get("corrupt_type")
    if flag:
        assert want == model_ct
        for entry in (pfinetune, ppartseg):
            src = inspect.getsource(entry)
            assert "propagate_corrupt_type" not in src and "init_model" not in src
        return
    got = propagate_corrupt_type(copy.deepcopy(cfg))
    assert got["model"].get("corrupt_type") == want
    assert cfg["model"].get("corrupt_type") == model_ct        # the input is not changed
