"""The port's furthest point sampling (``ops/fps.py``; on the CPU the
kernel's plain version) against the JAX package: bit for bit against its
XLA loop and its two Pallas kernels in interpret mode, with duplicated
points, points inside the unselectable radius, n < N and n == N; the
kernel gate against the union of the JAX gates; the CPU wrapper takes the
plain version and a tensor on another device never does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu import ops as jops
from point_dae_tpu.ops.pallas_fps import fps_pallas, fps_pallas_batched

from point_dae_torch.ops import fps, geometry
from point_dae_torch.ops.patchify import fps_rows


def _cloud(B, N, seed):
    """Normal points, a block of them duplicated, a few at the origin and
    one just inside the |p|^2 <= 1e-3 radius (never picked)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    pts[:, N // 2:N // 2 + N // 8] = pts[:, :N // 8]
    pts[0, 3:6] = 0.0
    pts[-1, 7] = np.float32(0.018)           # |p|^2 = 9.7e-4
    return pts


_xla_fps = jax.jit(jops.furthest_point_sample, static_argnums=1)


@pytest.mark.parametrize("B,N,n", [(3, 256, 64), (2, 96, 96), (2, 64, 80)])
def test_plain_fps_matches_jax_bit_for_bit(B, N, n):
    """n < N; n == N (every point taken: after the selectable ones run out
    the picks repeat as argmax resolves them); n > N."""
    pts = _cloud(B, N, N)
    want = np.asarray(_xla_fps(jnp.asarray(pts), n))
    got = fps.furthest_point_sample_plain(torch.from_numpy(pts), n)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin(got[0, 1:].numpy(), [3, 4, 5]).any()
    np.testing.assert_array_equal(fps_rows(torch.from_numpy(pts), n)[0].numpy(), want)
    # the dispatching entry point takes the plain version for a CPU tensor
    assert torch.equal(geometry.furthest_point_sample(torch.from_numpy(pts), n), got)


@pytest.mark.parametrize("batched", [True, False])
def test_plain_fps_matches_pallas_kernels_in_interpret_mode(batched):
    pts = _cloud(2, 256, 1)
    with pltpu.force_tpu_interpret_mode():
        want = (fps_pallas_batched(jnp.asarray(pts), 24, batch_tile=2) if batched
                else fps_pallas(jnp.asarray(pts), 24))
    got = fps.furthest_point_sample_plain(torch.from_numpy(pts), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_gate(N):
    """``geometry.py:115-126`` on a TPU without a mask: the batched kernel
    or the per-row kernel."""
    return (N >= 512 and N % 128 == 0) or (N >= 512 and N % 8 == 0)


@pytest.mark.parametrize("N", [64, 504, 511, 512, 520, 1000, 1024, 1200, 2048, 2400,
                               8192, 8200, 16384, 16392, 100000, 1 << 20])
def test_gate_is_the_union_of_the_jax_gates(N):
    assert fps.use_fps_kernel("cuda", N) is _jax_gate(N)
    assert fps.use_fps_kernel("cpu", N) is False


@pytest.mark.parametrize("N", [512, 1200, 8192, 8200, 16384, 16392, 100000, 1 << 20])
def test_kernel_takes_every_n_of_the_gate(N):
    """The JAX gates have no upper bound, and neither has the kernel: up to
    8192 points in registers, the streamed form above."""
    assert _jax_gate(N) and fps.use_fps_kernel("cuda", N)
    assert fps.kernel_takes(N, 1) and fps.kernel_takes(N, N)
    assert (N > fps.REGISTER_POINTS) is (N > 8192)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Inside the gate a tensor off the CPU launches the kernel or raises:
    on a host without a GPU the launch raises, for a cloud above the
    register form's 8192 points as below it."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran inside the gate")

    monkeypatch.setattr(fps, "furthest_point_sample_plain", boom)
    monkeypatch.setattr(fps, "use_fps_kernel", lambda dev, n: True)
    with pytest.raises(ValueError, match="expected one CUDA device"):
        fps.furthest_point_sample(torch.empty((2, 1024, 3), device="meta"), 16)
    with pytest.raises(ValueError, match="expected one CUDA device"):
        fps.furthest_point_sample(torch.empty((2, 8200, 3), device="meta"), 16)
