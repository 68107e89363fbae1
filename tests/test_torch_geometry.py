"""Port geometry (ops/geometry.py, ops/patchify.py, ops/gather.py) against
the JAX package on the CPU: FPS + kNN patchify and the small-C gather,
including the Pallas kernels run in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu import ops as jops
from point_dae_tpu.ops.pallas_patchify import fused_patchify_pallas
from point_dae_tpu.ops.pallas_scatter import (gather_rows as j_gather_rows,
                                              gather_rows_small_c_pallas)

from point_dae_torch.ops import geometry as G
from point_dae_torch.ops.gather import (gather_rows, gather_rows_small_c,
                                        use_scatter_kernel)
from point_dae_torch.ops.patchify import fused_patchify, fused_patchify_plain

from _torch_files import one_torch_thread  # noqa: F401


def test_fps_knn_and_group_neighborhood_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 256, 3)).astype(np.float32)
    pts[0, 5] = 0.0                                  # never selectable
    fps_j, center_j, idx_j = jax.jit(lambda p: jops.fps_knn(p, 16, 8))(pts)
    neigh_j, cen_j = jax.jit(lambda p: jops.group_neighborhood(p, 16, 8))(pts)
    fps_t, center_t, idx_t = G.fps_knn(torch.from_numpy(pts), 16, 8)
    neigh_t, cen_t = G.group_neighborhood(torch.from_numpy(pts), 16, 8)
    np.testing.assert_array_equal(fps_t.numpy(), np.asarray(fps_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(center_t.numpy(), np.asarray(center_j))
    np.testing.assert_array_equal(cen_t.numpy(), np.asarray(cen_j))
    np.testing.assert_array_equal(neigh_t.numpy(), np.asarray(neigh_j))
    assert fps_t.dtype == idx_t.dtype == torch.int32
    assert 5 not in fps_t[0].tolist()[1:]


def test_plain_patchify_matches_pallas_interpret():
    """The kernel's plain version == fused_patchify_pallas in interpret
    mode, idx-exact (both compute distances coordinate-wise)."""
    rng = np.random.default_rng(0)
    B, N, Gn, S = 3, 512, 16, 8
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    fps_j, knn_j = fused_patchify_pallas(jnp.asarray(pts), Gn, S, batch_tile=1,
                                         interpret=True)
    fps_t, knn_t = fused_patchify_plain(torch.from_numpy(pts), Gn, S)
    np.testing.assert_array_equal(fps_t.numpy(), np.asarray(fps_j))
    np.testing.assert_array_equal(knn_t.numpy(), np.asarray(knn_j))
    # the wrapper takes the plain version for a CPU tensor
    fps_w, knn_w = fused_patchify(torch.from_numpy(pts), Gn, S)
    assert torch.equal(fps_w, fps_t) and torch.equal(knn_w, knn_t)


def test_plain_gather_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    idx = rng.integers(0, 64, size=(2, 40)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = gather_rows_small_c_pallas(jnp.asarray(x), jnp.asarray(idx), tq=16)
    got = gather_rows_small_c(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_rows_gradient_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 6)).astype(np.float32)
    idx = rng.integers(0, 32, size=(2, 50)).astype(np.int32)
    cot = rng.normal(size=(2, 50, 6)).astype(np.float32)
    gj = jax.grad(lambda a: jnp.vdot(j_gather_rows(a, jnp.asarray(idx)), cot))(x)
    xt = torch.from_numpy(x).requires_grad_()
    (gather_rows(xt, torch.from_numpy(idx)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dev,nq,ndb,k,want", [
    ("cuda", 1024, 1024, 20, True),      # the reference EdgeConv at DGCNN shapes
    ("cuda", 64, 1024, 32, True),
    ("cuda", 64, 1024, 6, False),        # k < 8
    ("cuda", 1024, 2048, 20, False),     # database above one tile
    ("cuda", 1024, 500, 20, False),      # below 512, not a multiple of 128
    ("cuda", 63, 1024, 20, False),       # queries not a multiple of 8
    ("cpu", 1024, 1024, 20, False)])
def test_knn_gate_follows_jax(dev, nq, ndb, k, want):
    """The ``knn_pallas`` gate as a function of shapes and device type: open
    on CUDA exactly where the JAX package's is on a TPU; a CPU tensor keeps
    the plain path whatever its shape."""
    assert G.use_knn_kernel(dev, nq, ndb, k) is want
    if dev == "cpu":
        q = torch.zeros((1, 16, 3))
        assert G.knn(q, torch.zeros((1, 512, 3)), 8)[1].shape == (1, 16, 8)


@pytest.mark.parametrize("dev,B,Q,N,C,want", [
    ("cuda", 128, 20480, 1024, 64, True),     # the reference EdgeConv's backward
    ("cuda", 256, 2048, 1024, 3, False),      # the flagship's patch gather: C < 32
    ("cuda", 128, 20480, 4096, 64, False),    # N > 2048
    ("cuda", 2, 1024, 1024, 64, False),       # below 2^24 elements
    ("cpu", 128, 20480, 1024, 64, False)])
def test_scatter_gate_follows_jax(dev, B, Q, N, C, want):
    """``_use_mxu_scatter`` as a function of shapes and device type."""
    assert use_scatter_kernel(dev, B, Q, N, C) is want
