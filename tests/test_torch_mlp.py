"""The plain version of the port's fused_mlp_ln kernel against the JAX
package's fused_mlp_ln in interpret mode, forward and every gradient, with
and without the per-row scale, at R 256, C 128, H 512. Tolerances are
those of tests/test_pallas_mlp.py: errors against a full-f32 oracle, no
more than twice the unfused bf16 chain's (+1e-6 forward, +1e-4
gradients); the port and the JAX kernel are also held to each other by
the same bound.

The JAX kernel's forward and backward bodies are called through
``pallas_mlp._ln_core_call``: ``jax.grad`` through the package's
``fused_mlp_ln`` fails its custom-VJP type check with this jax (dgamma
comes back (C,) for a (1, C) primal), as tests/test_pallas_mlp.py's own
gradient test does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.ops.pallas_mlp import (_bwd_ln_kernel, _fwd_ln_kernel,
                                          _ln_core_call)

from point_dae_torch.ops.mlp import fused_mlp_ln

from _torch_files import one_torch_thread  # noqa: F401

R, C, H = 256, 128, 512
NAMES = ("dx", "dgamma", "dbeta", "dk1", "db1", "dk2", "db2")


def _setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(R, C)).astype(np.float32)
    k1 = (rng.normal(size=(C, H)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.02).astype(np.float32)
    k2 = (rng.normal(size=(H, C)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(C,)) * 0.02).astype(np.float32)
    gm = (1.0 + 0.1 * rng.normal(size=(C,))).astype(np.float32)
    bt = (0.05 * rng.normal(size=(C,))).astype(np.float32)
    sc = ((rng.uniform(size=(R,)) < 0.9) / 0.9).astype(np.float32)
    cot = rng.normal(size=(R, C)).astype(np.float32)
    return (x, gm, bt, k1, b1, k2, b2), sc, cot


def _ref(x, gm, bt, k1, b1, k2, b2, sc, dt):
    mu = jnp.mean(x, -1, keepdims=True)
    var = jnp.mean(x * x, -1, keepdims=True) - mu * mu
    h = ((x - mu) * jax.lax.rsqrt(var + 1e-6)) * gm + bt
    h = h.astype(dt) @ k1.astype(dt) + b1.astype(dt)
    h = jax.nn.gelu(h, approximate=False)
    out = (h.astype(dt) @ k2.astype(dt) + b2.astype(dt)).astype(jnp.float32)
    if sc is not None:
        out = out * sc[:, None]
    return x + out


def _jax_value_and_grads(fn, args, cot):
    def loss(*a):
        y = fn(*a)
        return jnp.vdot(y, cot), y
    vg = jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True)
    (_, y), g = jax.jit(vg)(*args)
    return np.asarray(y), [np.asarray(v, np.float32) for v in g]


def _jax_kernel(args, sc, cot):
    """Output and gradients of the Pallas kernels in interpret mode, laid
    out as ``_mlp_ln_core_bwd`` returns them (dk1, dk2 rounded to bf16)."""
    x, gm, bt, k1, b1, k2, b2 = map(jnp.asarray, args)
    bf = jnp.bfloat16
    prim = (x, gm.reshape(1, C), bt.reshape(1, C), k1.astype(bf),
            b1.reshape(1, H), k2.astype(bf), b2.reshape(1, C))
    scj = None if sc is None else jnp.asarray(sc).reshape(-1, 1)
    y = _ln_core_call(_fwd_ln_kernel, *prim, scj, None, 256, 1e-6, True,
                      is_bwd=False)
    dx, dk1, dk2, db = _ln_core_call(_bwd_ln_kernel, *prim, scj, jnp.asarray(cot),
                                     256, 1e-6, True, is_bwd=True)
    grads = (dx, db[2, :C], db[3, :C], dk1.astype(bf), db[0], dk2.astype(bf),
             db[1, :C])
    return np.asarray(y), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("scaled", [False, True])
def test_plain_fused_mlp_ln_matches_jax_kernel(scaled):
    args, sc, cot = _setup()
    s = sc if scaled else None
    sj = None if s is None else jnp.asarray(s)
    yo, go = _jax_value_and_grads(lambda *a: _ref(*a, sj, jnp.float32), args, cot)
    yu, gu = _jax_value_and_grads(lambda *a: _ref(*a, sj, jnp.bfloat16), args, cot)
    yk, gk = _jax_kernel(args, s, cot)

    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    yt = fused_mlp_ln(*ts, row_scale=None if s is None else torch.from_numpy(s))
    (yt * torch.from_numpy(cot)).sum().backward()
    assert yt.dtype == torch.float32 and yt.shape == (R, C)

    scale = np.maximum(np.abs(yo), 1e-3)
    err_u = float(np.max(np.abs(yu - yo) / scale))
    for name, y in (("port", yt.detach().numpy()), ("jax-kernel", yk)):
        assert float(np.max(np.abs(y - yo) / scale)) <= 2 * err_u + 1e-6, name
    assert float(np.max(np.abs(yt.detach().numpy() - yk) / scale)) <= 2 * err_u + 1e-6

    for name, o, u, k, t in zip(NAMES, go, gu, gk, ts):
        gt = t.grad.numpy()
        sc_ = float(np.max(np.abs(o))) + 1e-6
        eu = float(np.max(np.abs(u - o))) / sc_
        assert float(np.max(np.abs(gt - o))) / sc_ <= 2 * eu + 1e-4, name
        assert float(np.max(np.abs(gt - k))) / sc_ <= 2 * eu + 1e-4, name
