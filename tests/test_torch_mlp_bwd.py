"""The plain backwards of the port's MLP kernels, ``mlp_ln_bwd_plain`` and
``mlp_bwd_plain``, against the JAX package's Pallas backward kernels
(``pallas_mlp.py:_bwd_ln_kernel`` through ``_ln_core_call``, ``_bwd_kernel``
through ``_core_bwd_call``) in interpret mode, at R 256, C 128 and 256, H 4C,
with and without the per-row scale.

Both round where the kernels round (bf16 LN(x), s g, dh and GELU(h)), so
what is left between them is the order of the f32 sums (and the JAX
kernel's Abramowitz-Stegun erf, 1.5e-7 from erf). That order moves an f32
result by about 1e-6 of its size, and now and then an intermediate bf16
rounding of dh or GELU(h) by one step (2^-8 of the value); such a step
moves one term of a sum of at least C = 128 terms. The tolerance is 1e-3 of
each output's largest value, on the f32 results the Pallas kernels write
(``round_out=False``: the weight gradients before their callers round them
to bf16, a rounding that alone can move an output by 2^-8 of its size).
Measured: at most 7.8e-4 (dk2, C 128), 2e-7 on db2, which sees no bf16
rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.ops.pallas_mlp import _bwd_ln_kernel, _core_bwd_call, _ln_core_call

from point_dae_torch.ops import mlp

from _torch_files import one_torch_thread  # noqa: F401

R = 256
TOL = 1e-3
LN_NAMES = ("dx", "dgamma", "dbeta", "dk1", "db1", "dk2", "db2")
MLP_NAMES = ("dx", "dk1", "db1", "dk2", "db2")


def _setup(C, seed):
    H = 4 * C
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, C)).astype(np.float32)
    gm = (1.0 + 0.1 * rng.normal(size=(C,))).astype(np.float32)
    bt = (0.05 * rng.normal(size=(C,))).astype(np.float32)
    k1 = (rng.normal(size=(C, H)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.02 * rng.normal(size=(H,))).astype(np.float32)
    k2 = (rng.normal(size=(H, C)) / np.sqrt(H)).astype(np.float32)
    b2 = (0.02 * rng.normal(size=(C,))).astype(np.float32)
    sc = ((rng.uniform(size=(R,)) < 0.9) / 0.9).astype(np.float32)
    g = rng.normal(size=(R, C)).astype(np.float32)
    return x, gm, bt, k1, b1, k2, b2, sc, g


def _bf16(a):
    """numpy f32 -> the bf16 values as torch rounds them (both packages
    round to nearest even)."""
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_close(names, got, want):
    for name, a, b in zip(names, got, want):
        a = a.float().numpy()
        b = np.asarray(b, np.float32).reshape(a.shape)
        err = float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("C,scaled", [(128, False), (128, True), (256, True)])
def test_mlp_ln_bwd_plain_matches_jax_kernel(C, scaled):
    x, gm, bt, k1, b1, k2, b2, sc, g = _setup(C, C + scaled)
    H = 4 * C
    bf = jnp.bfloat16
    scj = jnp.asarray(sc).reshape(-1, 1) if scaled else None
    dx, dk1, dk2, db = _ln_core_call(
        _bwd_ln_kernel, jnp.asarray(x), jnp.asarray(gm).reshape(1, C),
        jnp.asarray(bt).reshape(1, C), jnp.asarray(k1).astype(bf), jnp.asarray(b1).reshape(1, H),
        jnp.asarray(k2).astype(bf), jnp.asarray(b2).reshape(1, C), scj, jnp.asarray(g),
        256, 1e-6, True, is_bwd=True)
    want = (dx, db[2, :C], db[3, :C], dk1, db[0], dk2, db[1, :C])

    args = (torch.from_numpy(x), torch.from_numpy(gm), torch.from_numpy(bt), _bf16(k1),
            torch.from_numpy(b1), _bf16(k2), torch.from_numpy(sc) if scaled else None,
            torch.from_numpy(g))
    raw = mlp.mlp_ln_bwd_plain(*args, round_out=False)
    _assert_close(LN_NAMES, raw, want)

    out = mlp.mlp_ln_bwd_plain(*args)
    f32, bf16 = torch.float32, torch.bfloat16
    assert [t.dtype for t in out] == [f32, f32, f32, bf16, f32, bf16, f32]
    for name, a, b in zip(LN_NAMES, out, raw):
        assert torch.equal(a, b.to(a.dtype)), name


@pytest.mark.parametrize("C", [128, 256])
def test_mlp_bwd_plain_matches_jax_kernel(C):
    x, _, _, k1, b1, k2, b2, _, g = _setup(C, 7 + C)
    H = 4 * C
    bf = jnp.bfloat16
    res = (jnp.asarray(x).astype(bf), jnp.asarray(k1).astype(bf), jnp.asarray(b1).reshape(1, H),
           jnp.asarray(k2).astype(bf), jnp.asarray(b2).reshape(1, C))
    dx, dk1, dk2, db = _core_bwd_call(res, jnp.asarray(g), 256, True)
    want = (dx, dk1, db[0], dk2, db[1, :C])

    args = (_bf16(x), _bf16(k1), torch.from_numpy(b1), _bf16(k2), torch.from_numpy(g))
    raw = mlp.mlp_bwd_plain(*args, round_out=False)
    _assert_close(MLP_NAMES, raw, want)

    out = mlp.mlp_bwd_plain(*args)
    f32, bf16 = torch.float32, torch.bfloat16
    assert [t.dtype for t in out] == [bf16, bf16, f32, bf16, f32]
    for name, a, b in zip(MLP_NAMES, out, raw):
        assert torch.equal(a, b.to(a.dtype)), name


@pytest.mark.parametrize("scaled", [False, True])
def test_fused_mlp_ln_plain_backward_is_mlp_ln_bwd_plain(scaled):
    """The CPU path of ``fused_mlp_ln`` differentiates through
    ``mlp_ln_bwd_plain``: its gradients are that function's outputs, dk1 and
    dk2 bf16 then widened to the f32 parameters' type, bit for bit."""
    x, gm, bt, k1, b1, k2, b2, sc, g = _setup(128, 3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gm, bt, k1, b1, k2, b2)]
    s = torch.from_numpy(sc) if scaled else None
    y = mlp.fused_mlp_ln(*leaves, row_scale=s)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    want = mlp.mlp_ln_bwd_plain(torch.from_numpy(x), leaves[1].detach(), leaves[2].detach(),
                                _bf16(k1), leaves[4].detach(), _bf16(k2), s, torch.from_numpy(g))
    for name, a, b in zip(LN_NAMES, got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b.float()), name


@pytest.mark.parametrize("R,C,H", [(16384, 384, 1536), (8192, 384, 1536), (512, 128, 512),
                                   (192, 384, 1536), (320, 768, 3072), (64, 1024, 4096)])
def test_weight_slices_fill_the_card_and_keep_every_slice(R, C, H):
    """The backward's row slices for dk1 and dk2: 11 at the flagship widths
    (72 output tiles x 11 = 792 blocks, three waves of 264 at two an SM),
    between 1 and R / 64, none empty (every slice of ceil(kt / S) k tiles
    starts inside the rows), and their f32 partials within 64 MiB."""
    S = mlp.weight_slices(R, C, H)
    kt = R // 64
    kps = -(-kt // S)
    assert 1 <= S <= kt and (S - 1) * kps < kt
    assert S * 2 * C * H * 4 <= max(64 << 20, 2 * C * H * 4)
    if (C, H) == (384, 1536) and R >= 8192:
        assert S == 11
