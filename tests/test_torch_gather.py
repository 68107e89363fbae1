"""The plain version of the port's wide row gather (``gather_rows_wide``,
the counterpart of ``point_dae_tpu/ops/pallas_scatter.py:
gather_rows_pallas``) against the JAX package's gather, exactly, at the
partseg DGCNN edge gather's width (C 64) and a ragged one, in f32 and
bf16 rows (the output is f32 either way, as the Pallas kernel's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_torch.ops import gather


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,C,Q", [(2, 256, 64, 1200), (3, 100, 5, 37)])
def test_plain_wide_gather_equals_take_along_axis(dtype, B, N, C, Q):
    """In-range indices: bit for bit ``jnp.take_along_axis`` (cast to f32,
    which is exact from bf16). Indices outside [0, N) give zero rows, as
    ``gather_rows_pallas``'s one-hot product does; the one-hot product at
    HIGHEST precision gives the same bits on the rest."""
    rng = np.random.default_rng(B * C)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, Q)).astype(np.int32)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jnp.take_along_axis(xj, jnp.asarray(idx)[..., None], axis=1)
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = gather.gather_rows_wide(xt, torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (B, Q, C)
    assert np.array_equal(got.numpy(), want)

    bad = idx.copy()
    bad[0, :3] = (-1, N, N + 7)
    onehot = (bad[..., None] == np.arange(N)).astype(np.float32)
    ref = np.asarray(jnp.einsum("bqn,bnc->bqc", jnp.asarray(onehot), xj.astype(jnp.float32),
                                precision="highest"))
    got = gather.gather_rows_wide(xt, torch.from_numpy(bad)).numpy()
    assert not got[0, :3].any() and np.array_equal(got, ref)


def test_wide_gather_raises_off_the_cpu_without_a_card():
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    another device never reaches the plain version."""
    x = torch.empty((2, 16, 64), device="meta")
    idx = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected one CUDA device"):
        gather.gather_rows_wide(x, idx)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        gather.gather_rows_wide(x.to(torch.float64), idx)
