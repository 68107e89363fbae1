"""The tiled kNN, the aggregate over a given idx and the EdgeConv plain
versions above 1024 points, against the JAX package on the CPU: the kNN
kernel's plain version against ``knn_pallas`` in interpret mode;
``aggregate_from_idx`` (forward, ``first`` and ``split`` gradients) against
the JAX ``aggregate_from_idx(interpret=True)``; ``knn_select_plain``,
``bwd_first_plain`` and ``bwd_split_plain`` at N 1100 against the JAX
``knn_aggregate(interpret=True)``; the hybrid EdgeConv layer against the
fused one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu.ops import pallas_edgeconv as jec
from point_dae_tpu.ops.pallas_knn import knn_pallas

from point_dae_torch.models.dgcnn import FusedEdgeConv
from point_dae_torch.ops import edgeconv as tec
from point_dae_torch.ops import geometry as G
from point_dae_torch.ops.tiled_knn import knn_kernel, knn_plain

from _torch_files import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("B,Nq,Ndb,C,k", [(2, 64, 512, 3, 8), (2, 512, 512, 16, 20)])
def test_knn_plain_matches_pallas_interpret(B, Nq, Ndb, C, k):
    """dists within 1e-5 relative (the Pallas tile takes one f32 product,
    the plain version sums channel by channel); idx equal except where two
    selected distances tie within that rounding, and those are counted:
    the JAX choice must then sit at the same distance in the port's own
    arithmetic. The queries of the first case are database points
    (distance 0 to themselves) and duplicates of them."""
    rng = np.random.default_rng(C)
    y = rng.normal(size=(B, Ndb, C)).astype(np.float32)
    q = rng.normal(size=(B, Nq, C)).astype(np.float32)
    if C == 3:
        q[:, :8] = y[:, 100:108]
        y[:, 200:204] = y[:, 100:104]            # exact ties: the lower index first
    with pltpu.force_tpu_interpret_mode():
        dj, ij = knn_pallas(jnp.asarray(q), jnp.asarray(y), k, tn=min(Nq, 1024), tm=Ndb)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = knn_plain(torch.from_numpy(q), torch.from_numpy(y), k)
    assert it.dtype == torch.int32 and dt.dtype == torch.float32
    dt, it = dt.numpy(), it.numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5 * np.abs(dj).max())
    differ = it != ij
    assert differ.mean() < 1e-3, int(differ.sum())
    # a differing pick is a near-tie: the JAX pick's distance, in the port's
    # arithmetic, equals the port's pick's within the rounding
    full = G.pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(y)).numpy()
    rows = np.nonzero(differ)
    np.testing.assert_allclose(full[rows[0], rows[1], ij[differ]],
                               full[rows[0], rows[1], it[differ]], rtol=1e-5, atol=1e-5)
    if C == 3:
        assert (it[:, :4, 0] == np.arange(100, 104)).all()
        assert (it[:, :4, 1] == np.arange(200, 204)).all()
    # the CPU dispatch: knn_kernel is the plain version there
    d2, i2 = knn_kernel(torch.from_numpy(q), torch.from_numpy(y), k)
    assert np.array_equal(i2.numpy(), it) and np.array_equal(d2.numpy(), dt)


@pytest.mark.parametrize("grad_mode", ["first", "split"])
def test_aggregate_from_idx_plain_matches_jax_interpret(grad_mode):
    """Over the idx of a kNN with duplicated points (value ties): max and
    min equal, sums within 1e-6 and du within 1e-5 of the largest magnitude
    (sums taken in another order)."""
    rng = np.random.default_rng(11)
    B, N, C, k = 2, 64, 8, 5
    xf = rng.normal(size=(B, N, 3)).astype(np.float32)
    U = rng.normal(size=(B, N, C)).astype(np.float32)
    xf[:, 40:48], U[:, 40:48] = xf[:, :8], U[:, :8]
    cot = [rng.normal(size=(B, N, C)).astype(np.float32) for _ in range(4)]
    idx = tec.knn_select_plain(torch.from_numpy(xf), k)

    def f(u):
        out = jec.aggregate_from_idx(u, jnp.asarray(idx.numpy()), k, N, True, 3, 3, grad_mode)
        return sum(jnp.vdot(o, c) for o, c in zip(out, cot)), out

    (_, want), gj = jax.value_and_grad(f, has_aux=True)(jnp.asarray(U))
    ut = torch.from_numpy(U).requires_grad_()
    got = tec.aggregate_from_idx(ut, idx, grad_mode)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cot)).backward()
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].detach().numpy(), np.asarray(want[i]))
    for i in (2, 3):
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].detach().numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    gj = np.asarray(gj)
    np.testing.assert_allclose(ut.grad.numpy(), gj, rtol=0, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("grad_mode", ["first", "split"])
def test_edgeconv_plain_above_1024_points_matches_jax_interpret(grad_mode):
    """At N 1100, above the register limit of one pass of the selection:
    neighbours, max and min equal, sums and du as for the smaller shapes."""
    rng = np.random.default_rng(12)
    B, N, C, Cf, k = 1, 1100, 4, 3, 6
    xf = rng.normal(size=(B, N, Cf)).astype(np.float32)
    U = rng.normal(size=(B, N, C)).astype(np.float32)
    xf[:, 1050:1058], U[:, 1050:1058] = xf[:, 3:11], U[:, 3:11]
    cot = [rng.normal(size=(B, N, C)).astype(np.float32) for _ in range(4)]

    def f(u):
        out = jec.knn_aggregate(u, jnp.asarray(xf), k, 100, True, 3, 3, grad_mode)
        return sum(jnp.vdot(o, c) for o, c in zip(out[:4], cot)), out

    (_, want), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(U))
    ut = torch.from_numpy(U).requires_grad_()
    got = tec.knn_aggregate(ut, torch.from_numpy(xf), k, grad_mode)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got[:4], cot)).backward()
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert (got[4][0, 1050:1058, 0].numpy() == np.arange(3, 11)).all()
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].detach().numpy(), np.asarray(want[i]))
    for i in (2, 3):
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].detach().numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    gj = np.asarray(gj)
    np.testing.assert_allclose(ut.grad.numpy(), gj, rtol=0, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("grad_mode", ["first", "split"])
def test_hybrid_edgeconv_matches_fused(grad_mode):
    """``knn_impl='xla'`` with the plain versions: the layer's output and
    its gradients against the fused layer's, at a near-tie-free cloud (the
    hybrid's kNN sorts the clamped matrix-expansion distances, the fused
    one the channel-order sums) within f32 rounding."""
    torch.manual_seed(0)
    x = torch.randn(2, 96, 5)
    cot = torch.randn(2, 96, 16)
    outs = []
    for impl in ("kernel", "xla"):
        layer = FusedEdgeConv(5, 16, k=7, generator=torch.Generator().manual_seed(3),
                              interpret=True, grad_mode=grad_mode, knn_impl=impl).train()
        xi = x.clone().requires_grad_()
        y = layer(xi)
        (y * cot).sum().backward()
        outs.append((y.detach(), xi.grad, layer.conv.weight.grad, layer.bn.running_var))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
