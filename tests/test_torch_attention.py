"""The port's fused attention (on the CPU: its plain version, forward and
hand-written backward) against the JAX package's Pallas kernel in interpret
mode at B 16, H 2, d 64, T in {32, 64}, with and without a key mask, and
for both of the TPU kernel's tile sizes bc in {1, 4}: the port has no tile
and must match either.

Tolerances. Forward: rtol 1e-4, atol 1e-5 (same bf16 rounding points, f32
sums in another order). dq, dk, dv: rtol 2**-6, atol 1e-4, one bf16 step,
since each is rounded to bf16 after f32 sums taken in different orders.
As in tests/test_torch_folding.py an f32 difference in the last bit can
cross a bf16 rounding boundary of an intermediate (the probabilities, the
scaled score gradient), so 98% of the elements must meet the tolerance and
all of them the tolerance widened by 2**-7."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.ops import pallas_attn

from point_dae_torch.models import layers as tlayers
from point_dae_torch.ops import attention

B, H, D = 16, 2, 64
FLIP = 2 ** -7


def _assert_close(got, want, rtol, atol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.98, (name, float(close.mean()))
    np.testing.assert_allclose(got, want, rtol=rtol + FLIP, atol=atol + FLIP,
                               err_msg=name)


def _setup(T, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = rng.uniform(size=(B, T)) < 0.7
        mask[np.arange(B), rng.integers(0, T, B)] = True    # a valid key per cloud
    return q, k, v, cot, mask


CASES = [(T, masked, bc) for T in (32, 64) for masked in (False, True) for bc in (1, 4)]


@pytest.mark.parametrize("T,masked,bc", CASES)
def test_forward_and_gradients_match_jax_kernel(T, masked, bc):
    q, k, v, cot, mask = _setup(T, masked)
    mj = None if mask is None else jnp.asarray(mask)

    def fn(q_, k_, v_):
        return pallas_attn.fused_attention(q_, k_, v_, key_mask=mj, bc=bc,
                                           interpret=True)

    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(cot))

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = attention.fused_attention(*ts, None if mask is None else torch.from_numpy(mask))
    assert got.shape == (B, T, H, D) and got.dtype == torch.float32
    _assert_close(got.detach().numpy(), want, rtol=1e-4, atol=1e-5, name="out")
    got.backward(torch.from_numpy(cot))
    for name, t, w in zip(("dq", "dk", "dv"), ts, want_g):
        _assert_close(t.grad.numpy(), w, rtol=2 ** -6, atol=1e-4, name=name)
    if masked:
        assert float(ts[1].grad[torch.from_numpy(~mask)].abs().max()) == 0.0
        assert float(ts[2].grad[torch.from_numpy(~mask)].abs().max()) == 0.0


@pytest.mark.parametrize("T,masked", [(32, True), (64, False)])
def test_attention_module_fused_branch_matches_jax_assembly(T, masked):
    """``Attention.forward_fused`` (on the CPU through the plain version)
    against qkv Dense -> interpret-mode kernel -> proj Dense assembled from
    the JAX package's functions with the same weights, as
    ``point_dae_tpu/models/layers.py:239-246`` assembles them."""
    C = H * D
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    wproj = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)
    bproj = (0.05 * rng.normal(size=(C,))).astype(np.float32)
    mask = _setup(T, masked, seed=6)[4]
    bf = jnp.bfloat16

    qkv = fnn.Dense(3 * C, use_bias=False, dtype=bf).apply(
        {"params": {"kernel": jnp.asarray(wqkv)}}, jnp.asarray(x))
    qkv4 = qkv.reshape(B, T, 3, H, D)
    out = pallas_attn.fused_attention(
        qkv4[:, :, 0], qkv4[:, :, 1], qkv4[:, :, 2],
        key_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    want = fnn.Dense(C, dtype=bf).apply(
        {"params": {"kernel": jnp.asarray(wproj), "bias": jnp.asarray(bproj)}},
        out.reshape(B, T, C).astype(bf))

    att = tlayers.Attention(C, H, dtype=torch.bfloat16)
    att.load_state_dict({"qkv.weight": torch.from_numpy(wqkv.T.copy()),
                         "proj.weight": torch.from_numpy(wproj.T.copy()),
                         "proj.bias": torch.from_numpy(bproj)})
    got = att.forward_fused(torch.from_numpy(x),
                            None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    # bf16 outputs of bf16 Dense layers: one bf16 step
    _assert_close(got.float().detach().numpy(), np.asarray(want, np.float32),
                  rtol=2 ** -7, atol=2 ** -7, name="proj")


def test_gate_follows_jax_and_stays_closed_on_cpu(monkeypatch):
    """Where the TPU kernel's tile terms hold (B 256, its own pick of bc)
    the two gates agree; and on a CPU tensor the module stays unfused."""
    for t in (1, 2, 32, 64):
        for d in (32, 60, 64, 256, 264):
            assert attention.supported(256, t, 6, d) == pallas_attn.supported(
                256, t, 6, d, pallas_attn.pick_bc(256, t)), (t, d)

    def boom(*a, **k):
        raise AssertionError("the fused attention gate opened on a CPU tensor")

    monkeypatch.setattr(tlayers, "fused_attention", boom)
    att = tlayers.Attention(128, 2, dtype=torch.bfloat16)
    assert att(torch.zeros(2, 32, 128)).shape == (2, 32, 128)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: here (no
    GPU) a tensor on another device must raise, not run the plain version."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(attention._AttnCorePlain, "forward", boom)
    q = torch.empty((4, 32, 2, 64), device="meta")
    with pytest.raises(ValueError, match="expected one CUDA device"):
        attention.fused_attention(q, q, q)
    narrow = torch.empty((4, 8, 2, 32), device="meta")    # inside the gate
    assert attention.supported(4, 8, 2, 32)
    with pytest.raises(ValueError, match="built for"):
        attention.fused_attention(narrow, narrow, narrow)
