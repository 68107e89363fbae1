"""The JAX package's random draws, replayed from its keys as its functions
split them, in the port's draws layout: the cloud corruptions of
``corrupt_cloud``, the augmentations of ``augment_cloud``, the patch
corruptions of ``corrupt_patches`` and the pretrain step's pipeline.
The parity tests feed these to the port so that both packages compute on
the same draws."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from point_dae_tpu.data import corruptions as jc
from point_dae_tpu.data import corruptions_patch as jcp

from point_dae_torch.data import corruptions as tc
from point_dae_torch.data import corruptions_patch as tcp


def _affine_param(name, key, level):
    """The draw inside ``jc._AFFINE_FNS[name](key, level)``."""
    u = jax.random.uniform
    fixed = {"translate": 0.5, "translate_tiny": 0.1, "translate_middle": 0.3,
             "translate_too_large": 0.8}
    if name in fixed:
        return u(key, (3,), minval=-fixed[name], maxval=fixed[name])
    scale = {"scale_nonorm": 2.0, "scale_nonorm_1p5": 1.5, "scale_nonorm_4": 4.0,
             "scale_nonorm_10": 10.0}
    if name in scale:
        s = scale[name]
        return u(key, (3,), minval=1.0 / s, maxval=s)
    if name == "rotate":
        return u(key, (3,), minval=-math.pi, maxval=math.pi)
    if name.startswith("rotate_level"):
        clip = math.pi / 5.0 * (float(name[-1]) + 1.0)
        return u(key, (3,), minval=-clip, maxval=clip)
    if name == "reflection":
        return jax.random.bernoulli(key, 0.5, (3,))
    shear = {"shear": 0.5, "shear_p5": 0.5, "shear_p1": 0.1, "shear_p3": 0.3,
             "shear_p8": 0.8, "shear_1p": 1.0, "shear_2p": 2.0}
    if name in shear:
        return u(key, (6,), minval=-shear[name], maxval=shear[name])
    if name == "shear_small":
        clip = 0.02 * (level + 1.0)
        return u(key, (6,), minval=-clip, maxval=clip)
    assert name == "rotate_z", name
    clip = math.pi / 5.0 * (level + 1.0)
    return u(key, (), minval=-clip, maxval=clip)


def _composite(key, max_n, names):
    k_n, k_perm, k_lv, *kp = jax.random.split(key, 3 + len(names))
    levels = jax.random.randint(k_lv, (len(names),), 0, 5).astype(jnp.float32)
    return {"count": jax.random.randint(k_n, (), 1, max_n + 1),
            "perm": jax.random.permutation(k_perm, len(names)),
            "levels": levels,
            "params": tuple(_affine_param(nm, kp[i], levels[i])
                            for i, nm in enumerate(names))}


def _dropout_local(key, n, max_clusters, ratio):
    k_ratio, k_nc, k_sizes, k_seeds = jax.random.split(key, 4)
    nc = jax.random.randint(k_nc, (), 1, max_clusters)
    return {"ratio": jax.random.uniform(k_ratio, (), minval=0.1, maxval=0.5)
            if ratio is None else jnp.float32(ratio),
            "num_clusters": nc,
            "picks": jax.random.randint(k_sizes, (n,), 0, jnp.maximum(nc, 1)),
            "seed_u": jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
                jax.random.split(k_seeds, max_clusters - 1))}


def _ball(key, extra):
    k1, k2, k3 = jax.random.split(key, 3)
    return jnp.concatenate([
        jax.random.uniform(k1, (extra, 1)),
        jax.random.uniform(k2, (extra, 1), minval=-1.0, maxval=1.0),
        jax.random.uniform(k3, (extra, 1), minval=0.0, maxval=2 * math.pi)], 1)


def _add_local(key, n, extra):
    k_nc, k_sizes, k_sigma, k_anchor, k_noise = jax.random.split(key, 5)
    nc = jax.random.randint(k_nc, (), 1, 8)
    return {"num_clusters": nc,
            "picks": jax.random.randint(k_sizes, (extra,), 0, jnp.maximum(nc, 1)),
            "anchor_u": jax.random.uniform(k_anchor, (n,)),
            "sigma": jax.random.uniform(k_sigma, (7,), minval=0.075, maxval=0.125),
            "noise": jax.random.normal(k_noise, (extra, 3))}


def cloud_draws(key, n, types):
    """One cloud's draws of ``jc.corrupt_cloud(key, (n, 3) points, types)``:
    (levels (T,), [one dict or array a position, None for a no-op])."""
    levels, ops, rows = [], [], n
    for i, t in enumerate(types):
        k_lv, k_op = jax.random.split(jax.random.fold_in(key, i))
        level = jax.random.randint(k_lv, (), 0, 5).astype(jnp.float32)
        levels.append(level)
        if t in ("clean", "dropout_patch_pointmae") or t.startswith("dropout_global"):
            d = None
        elif t in tc._COMPOSITES:
            d = _composite(k_op, *tc._COMPOSITES[t])
        elif t in jc._AFFINE_FNS:
            d = _affine_param(t, k_op, level)
        elif t == "scale":
            d = jax.random.uniform(k_op, (3,), minval=1.0 / 2.0, maxval=2.0)
        elif t == "scale_single":
            sv = jnp.array([1.6, 1.7, 1.8, 1.9, 2.0])[level.astype(jnp.int32)]
            d = jax.random.uniform(k_op, (1,), minval=1.0 / sv, maxval=sv)
        elif t == "jitter" or t.startswith("jitter_p"):
            d = jax.random.normal(k_op, (rows, 3))
        elif t.startswith("dropout_local"):
            d = _dropout_local(k_op, rows, *tc._dropout_local_spec(t))
        elif t == "add_global":
            d = _ball(k_op, n // 2)
        elif t == "add_local":
            d = _add_local(k_op, rows, n // 2)
        elif t == "random_add":
            k_c, k_a = jax.random.split(k_op)
            d = {"coin": jax.random.uniform(k_c) > 0.5, "ball": _ball(k_a, n // 2),
                 "local": _add_local(k_a, rows, n // 2)}
        else:
            assert t == "nonuniform_density", t
            k_v, k_r = jax.random.split(k_op)
            d = {"view": jax.random.normal(k_v, (3,)),
                 "r": jax.random.uniform(k_r, (rows,))}
        if t in ("add_global", "add_local", "random_add"):
            rows += n // 2
        ops.append(d)
    return jnp.stack(levels) if levels else jnp.zeros((0,)), ops


def _t(a):
    return torch.from_numpy(np.array(a))


def to_cloud_draws(types, levels, ops) -> tc.CloudCorruptDraws:
    """Batched (vmapped) ``cloud_draws`` output -> the port's draws."""
    out = []
    for t, d in zip(types, ops):
        if d is None:
            out.append(None)
        elif t in tc._COMPOSITES:
            out.append(tc.CloudAffineDraws(_t(d["count"]), _t(d["perm"]), _t(d["levels"]),
                                           tuple(_t(p) for p in d["params"])))
        elif t.startswith("dropout_local"):
            out.append(tc.DropoutLocalDraws(**{k: _t(v) for k, v in d.items()}))
        elif t == "add_local":
            out.append(tc.AddLocalDraws(**{k: _t(v) for k, v in d.items()}))
        elif t == "random_add":
            out.append(tc.RandomAddDraws(_t(d["coin"]), _t(d["ball"]), tc.AddLocalDraws(
                **{k: _t(v) for k, v in d["local"].items()})))
        elif t == "nonuniform_density":
            out.append(tc.DensityDraws(_t(d["view"]), _t(d["r"])))
        else:
            out.append(_t(d))
    return tc.CloudCorruptDraws(_t(levels), out)


def batch_cloud_draws(keys, n, types) -> tc.CloudCorruptDraws:
    """The port's draws of ``vmap(corrupt_cloud)`` over ``keys``."""
    levels, ops = jax.jit(jax.vmap(lambda k: cloud_draws(k, n, types)))(keys)
    return to_cloud_draws(types, *jax.device_get((levels, ops)))


def augment_draws(key, types):
    """One cloud's draws of ``jc.augment_cloud(key, points, types)``."""
    out = []
    for i, t in enumerate(types):
        k = jax.random.fold_in(key, i)
        if t == "translate":
            out.append(jax.random.uniform(k, (3,), minval=-0.2, maxval=0.2))
        elif t == "scale":
            out.append(jax.random.uniform(k, (3,), minval=2.0 / 3.0, maxval=3.0 / 2.0))
        elif t == "rotate_z":
            clip = math.pi / 5.0 * (4.0 + 1.0)
            out.append(jax.random.uniform(k, (), minval=-clip, maxval=clip))
        elif t == "rotate":
            out.append(jax.random.uniform(k, (3,), minval=-math.pi, maxval=math.pi))
        else:
            out.append(None)
    return out


def batch_augment_draws(keys, types):
    ops = jax.device_get(jax.jit(jax.vmap(lambda k: augment_draws(k, types)))(keys))
    return [None if d is None else _t(d) for d in ops]


def patch_draws_raw(key, types, shape):
    """The draws of ``jcp.corrupt_patches(key, neigh (B, G, S, 3), center,
    types)`` as JAX arrays (jittable), one tuple a position."""
    B, G, S = shape
    out = []
    for i, t in enumerate(types):
        k = jax.random.fold_in(key, i)
        if t in ("clean", "Drop-Patch"):
            out.append(None)
        elif t == "affine_r3":
            out.append(jcp._sample_affine_r3(k, B, False))
        elif t in jcp.AFFINE_NAMES or t == "rotate_z":
            out.append(jcp._params(k, t, B, 4.0, False))
        elif t == "jitter":
            k1, k2 = jax.random.split(k)
            out.append((jax.random.normal(k1, (B, G, S, 3)), jax.random.normal(k2, (B, G, 3))))
        elif t == "dropout_global":
            _, k_perm, k_fill = jax.random.split(k, 3)
            keep = max(tcp._dropout_keep(S), 1)
            out.append((jax.random.uniform(k_perm, (B, G, S)),
                        jax.random.randint(k_fill, (B, G, S), 0, keep)))
        elif t == "add_local":
            _, k_pick, k_sigma, k_noise = jax.random.split(k, 4)
            out.append((jax.random.uniform(k_sigma, (), minval=0.075, maxval=0.125),
                        jax.random.uniform(k_pick, (B, G, S)),
                        jax.random.normal(k_noise, (B, G, S, 3))))
        else:
            assert t == "scan", t
            _, k_v, k_r = jax.random.split(k, 3)
            out.append((jax.random.normal(k_v, (3,)), jax.random.uniform(k_r, (B, G, S))))
    return out


_PATCH_DRAWS = {"jitter": tcp.PatchJitterDraws, "dropout_global": tcp.PatchDropoutDraws,
                "add_local": tcp.PatchAddLocalDraws, "scan": tcp.PatchScanDraws}


def to_patch_draws(types, raw):
    """``patch_draws_raw`` output (on the host) -> the port's draws."""
    out = []
    for t, d in zip(types, raw):
        if d is None:
            out.append(None)
        elif t == "affine_r3":
            count, perm, A, b, m = d
            out.append(tcp.AffineR3Draws(int(count), np.asarray(perm).tolist(),
                                         _t(A), _t(b), _t(m)))
        elif t in _PATCH_DRAWS:
            out.append(_PATCH_DRAWS[t](*map(_t, d)))
        else:
            out.append(tcp.PatchAffineDraws(*map(_t, d)))
    return out


def patch_draws(key, types, shape):
    """The port's draws of ``jcp.corrupt_patches(key, ...)``."""
    raw = jax.device_get(jax.jit(lambda k: patch_draws_raw(k, types, shape))(key))
    return to_patch_draws(types, raw)


def pipeline_draws(key, raw, aug_type, corrupt_type, npoints):
    """Every draw of the JAX step's ``device_pipeline`` from the step key
    (the step splits it five ways and hands the first to the pipeline), in
    the port's ``PipelineDraws`` layout; the corrupted stream's ranks come
    from the JAX corruption's masks."""
    from point_dae_torch.engine.pretrain import PipelineDraws

    B, nraw = raw.shape[:2]
    aug_type, corrupt_type = tuple(aug_type), tuple(corrupt_type)

    @jax.jit
    def replay(key, pts):
        k_pipe = jax.random.split(key, 5)[0]
        k_aug, k_cor, k_s1, k_s2 = jax.random.split(k_pipe, 4)
        keys_a, keys_c = jax.random.split(k_aug, B), jax.random.split(k_cor, B)
        xyz = jax.vmap(lambda k, p: jc.augment_cloud(k, p, aug_type))(keys_a, pts)
        outs, masks = jax.vmap(lambda k, p: jc.corrupt_cloud(k, p, corrupt_type))(keys_c, xyz)
        if masks is None:
            corrupted = jax.random.randint(k_s2, (B, npoints), 0, outs.shape[1])
        else:
            cnt = jnp.maximum(jnp.sum(masks, axis=1, dtype=jnp.int32), 1)
            corrupted = jax.random.randint(k_s2, (B, npoints), 0, cnt[:, None])
        clean = jax.random.randint(k_s1, (B, npoints), 0, nraw)
        return (corrupted, clean,
                jax.vmap(lambda k: cloud_draws(k, nraw, corrupt_type))(keys_c),
                jax.vmap(lambda k: augment_draws(k, aug_type))(keys_a))

    corrupted, clean, cloud, aug = jax.device_get(replay(key, jnp.asarray(raw[..., :3])))
    return PipelineDraws(_t(corrupted).long(), _t(clean).long(),
                         to_cloud_draws(corrupt_type, *cloud),
                         [None if d is None else _t(d) for d in aug])


def level_draws(key, pts, name, level):
    """The draws of the JAX package's ``robustness.corrupt_batch_level(key,
    pts (B, n, 3), name, level)`` as the port's ``LevelDraws``, with the
    JAX output (jittable: ``name`` and ``level`` static). The resample's
    ranks are JAX's own, drawn against the validity mask its corruption
    returns."""
    from point_dae_tpu.engine import robustness as jrob

    from point_dae_torch.engine.robustness import DROPOUT_RATES, SCALE_LEVELS

    B, n = pts.shape[:2]
    ones = jnp.ones(n, bool)
    lv = jnp.float32(level)

    def one(k, p):
        if name == "scale":
            s = SCALE_LEVELS[level]
            return jax.random.uniform(k, (3,), minval=1.0 / s, maxval=s), None
        if name == "jitter":
            return jax.random.normal(k, p.shape), None
        if name == "rotate":
            clip = math.pi / 5.0 * (float(level) + 1.0)
            return jax.random.uniform(k, (3,), minval=-clip, maxval=clip), None
        k1, k2 = jax.random.split(k)
        if name == "dropout_global":
            op, mask = jax.random.uniform(k1, (n,)), jc.dropout_global(
                k1, ones, DROPOUT_RATES[level])
        elif name == "dropout_local":
            op = _dropout_local(k1, n, 8, 0.1 * (level + 1))
            mask = jc.dropout_local(k1, p, ones, drop_ratio=0.1 * (level + 1))
        elif name == "add_global":
            op, (_, mask) = _ball(k1, n // 2), jc.add_global(k1, p, ones, lv, n + n // 2)
        else:
            op, (_, mask) = _add_local(k1, n, n // 2), jc.add_local(k1, p, ones, lv,
                                                                   n + n // 2)
        cnt = jnp.maximum(jnp.sum(mask, dtype=jnp.int32), 1)
        return op, jax.random.randint(k2, (n,), 0, cnt)

    ops, ranks = jax.vmap(one)(jax.random.split(key, B), pts)
    out = jrob.corrupt_batch_level(key, pts, name, level)
    return ops, ranks, out


def to_level_draws(name, ops, ranks):
    """``level_draws`` output (on the host) -> the port's ``LevelDraws``."""
    from point_dae_torch.engine.robustness import LevelDraws

    if name == "dropout_local":
        ops = tc.DropoutLocalDraws(**{k: _t(v) for k, v in ops.items()})
    elif name == "add_local":
        ops = tc.AddLocalDraws(**{k: _t(v) for k, v in ops.items()})
    else:
        ops = _t(ops)
    return LevelDraws(ops, None if ranks is None else _t(ranks).long())
