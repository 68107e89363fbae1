"""The plain forwards of the port's MLP kernels, ``_mlp_ln_fwd_plain`` (with
and without the per-row scale) and ``fused_mlp_plain``, against the JAX
package's Pallas forward kernels in interpret mode
(``pallas_mlp.py:_fwd_ln_kernel`` through ``_ln_core_call``, and
``fused_mlp``), at R 256 and four (C, H) inside the JAX gate.

The plain forwards are what the card holds the CUDA forwards to; here they
are held to the TPU kernels at more widths than the single shape of
``tests/test_torch_mlp.py`` and ``tests/test_torch_residual.py``. Both sides
round where the kernels round (bf16 LN(x), bf16 GELU(h)), so what is left is
the JAX kernel's Abramowitz-Stegun erf (1.5e-7 from erf) and the order of
its sums, which can move a bf16 rounding of the hidden by one step (2^-8)
here and there: the bound is 2e-3 of the branch's largest value (mlp_ln:
y - x), that of ``tests/test_torch_residual.py``. Measured: at most 8.6e-4
(mlp_ln with the row scale, C 128, H 128), 2.0e-5 to 2.2e-4 for mlp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.ops import pallas_mlp
from point_dae_tpu.ops.pallas_mlp import _fwd_ln_kernel, _ln_core_call

from point_dae_torch.ops import mlp

from _torch_files import one_torch_thread  # noqa: F401

R = 256
TOL = 2e-3
SHAPES = [(128, 128), (128, 512), (256, 256), (256, 1024)]


def _setup(C, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, C)).astype(np.float32)
    gm = (1.0 + 0.1 * rng.normal(size=(C,))).astype(np.float32)
    bt = (0.05 * rng.normal(size=(C,))).astype(np.float32)
    k1 = (rng.normal(size=(C, H)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.02 * rng.normal(size=(H,))).astype(np.float32)
    k2 = (rng.normal(size=(H, C)) / np.sqrt(H)).astype(np.float32)
    b2 = (0.02 * rng.normal(size=(C,))).astype(np.float32)
    sc = ((rng.uniform(size=(R,)) < 0.9) / 0.9).astype(np.float32)
    return x, gm, bt, k1, b1, k2, b2, sc


def _assert_branch_close(got, want, base):
    err = float(np.max(np.abs((got - base) - (want - base))))
    assert err <= TOL * float(np.max(np.abs(want - base))), err


@pytest.mark.parametrize("C,H", SHAPES)
@pytest.mark.parametrize("kind", ["ln_scaled", "ln", "mlp"])
def test_plain_mlp_forward_matches_jax_kernel(C, H, kind):
    assert pallas_mlp.supported(R, C, H) and mlp.supported(R, C, H)
    x, gm, bt, k1, b1, k2, b2, sc = _setup(C, H, C + H + len(kind))
    bf = jnp.bfloat16
    if kind == "mlp":
        want = pallas_mlp.fused_mlp(*map(jnp.asarray, (x, k1, b1, k2, b2)), interpret=True)
        got = mlp.fused_mlp_plain(*map(torch.from_numpy, (x, k1, b1, k2, b2)))
        _assert_branch_close(got.numpy(), np.asarray(want, np.float32), 0.0)
        return
    scaled = kind == "ln_scaled"
    want = _ln_core_call(
        _fwd_ln_kernel, jnp.asarray(x), jnp.asarray(gm).reshape(1, C),
        jnp.asarray(bt).reshape(1, C), jnp.asarray(k1).astype(bf), jnp.asarray(b1).reshape(1, H),
        jnp.asarray(k2).astype(bf), jnp.asarray(b2).reshape(1, C),
        jnp.asarray(sc).reshape(-1, 1) if scaled else None, None, 256, 1e-6, True,
        is_bwd=False)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, gm=gm, bt=bt, b1=b1, b2=b2, sc=sc).items()}
    got = mlp._mlp_ln_fwd_plain(t["x"], t["gm"], t["bt"], torch.from_numpy(k1).to(torch.bfloat16),
                                t["b1"], torch.from_numpy(k2).to(torch.bfloat16), t["b2"],
                                t["sc"] if scaled else None, 1e-6)
    assert got.dtype == torch.float32 and got.shape == (R, C)
    _assert_branch_close(got.numpy(), np.asarray(want, np.float32), x)
