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

from _torch_files import one_torch_thread  # noqa: F401


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


@pytest.mark.parametrize("B,N,C,Q", [(2, 1024, 3, 2048), (3, 100, 8, 37), (1, 64, 1, 5)])
def test_small_c_gather_takes_int32_and_int64_indices(B, N, C, Q):
    """The small-C wrapper and ``gather_rows`` take int32 and int64 indices
    as given (the kernel reads either, no cast): on the CPU both dtypes give
    the same plain result, bit for bit ``jnp.take_along_axis``."""
    rng = np.random.default_rng(B * N + C)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, Q))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx)[..., None], axis=1))
    xt = torch.from_numpy(x)
    for dtype in (torch.int32, torch.int64):
        it = torch.from_numpy(idx).to(dtype)
        for fn in (gather.gather_rows_small_c, gather.gather_rows):
            got = fn(xt, it)
            assert got.dtype == torch.float32 and got.shape == (B, Q, C)
            assert np.array_equal(got.numpy(), want), (fn.__name__, dtype)


def test_small_c_gather_raises_off_the_cpu_without_a_card():
    """Off the CPU the small-C wrapper launches its kernel or raises, for
    either index dtype and for a non-contiguous x; an index whose batch
    differs from x's is refused before any pointer is passed."""
    x = torch.empty((2, 16, 3), device="meta")
    for dtype in (torch.int32, torch.int64, torch.int16):
        idx = torch.zeros((2, 8), dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="expected one CUDA device"):
            gather.gather_rows_small_c(x, idx)
        with pytest.raises(ValueError, match="expected one CUDA device"):
            gather.gather_rows_small_c(torch.empty((2, 3, 16), device="meta").transpose(1, 2),
                                       idx)
    with pytest.raises(ValueError, match="is not \\(B, Q\\)"):
        gather.gather_rows_small_c(x, torch.zeros((3, 8), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="C<=8"):
        gather.gather_rows_small_c(torch.empty((2, 16, 9), device="meta"),
                                   torch.zeros((2, 8), dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_gather_takes_int64_indices_out_of_range(dtype):
    """int64 indices, some of them -1, N and far past N: the plain version
    and the wrapper (on the CPU, the plain version) give zero rows there and
    the int32 result elsewhere, bit for bit ``jnp.take_along_axis``."""
    B, N, C, Q = 2, 300, 64, 517
    rng = np.random.default_rng(64)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, Q)).astype(np.int64)
    bad = idx.copy()
    bad[0, :3] = (-1, N, 2 ** 40)
    bad[1, -1] = -(2 ** 35)
    xj = jnp.asarray(x).astype(dtype)
    want = np.array(jnp.take_along_axis(xj, jnp.asarray(idx.astype(np.int32))[..., None],
                                        axis=1).astype(jnp.float32))
    want[0, :3] = 0.0
    want[1, -1] = 0.0
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for fn in (gather.gather_rows_wide, gather.gather_rows_wide_plain):
        got = fn(xt, torch.from_numpy(bad))
        assert got.dtype == torch.float32 and got.shape == (B, Q, C)
        assert np.array_equal(got.numpy(), want), fn.__name__
    meta = torch.empty((B, N, C), device="meta")
    with pytest.raises(ValueError, match="expected one CUDA device"):
        gather.gather_rows_wide(meta, torch.zeros((B, Q), dtype=torch.int64, device="meta"))
