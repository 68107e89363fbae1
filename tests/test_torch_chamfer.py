"""Port chamfer losses (losses/chamfer.py) against the JAX package on the
CPU: the patch-chamfer kernel's plain version against the Pallas kernel in
interpret mode, and the losses' values and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu.losses import chamfer as jch

from point_dae_torch.losses.chamfer import (chamfer_l2, masked_chamfer_l2,
                                            nn_half_small, nn_half_tiled,
                                            use_tiled_kernel)

from _torch_files import one_torch_thread  # noqa: F401


def test_plain_patch_chamfer_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(37, 12, 3)).astype(np.float32)
    b = rng.normal(size=(37, 8, 3)).astype(np.float32)
    b[3, 5] = b[3, 2]                         # an exact tie: first index wins
    with pltpu.force_tpu_interpret_mode():
        dj, ij, nj = jch._nn_half_small_pallas(jnp.asarray(a), jnp.asarray(b),
                                               lane_tile=16)
    dt, it, nt = nn_half_small(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # XLA's CPU code may contract the distance into fused multiply-adds
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("shapes", [((40, 36, 3), (40, 32, 3)),
                                    ((3, 64, 3), (3, 16, 3))])
def test_losses_and_gradients_match_jax(shapes):
    """masked_chamfer_l2 (the patch loss) and chamfer_l2 (the global loss):
    values and gradients to both inputs, rtol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shapes[0]).astype(np.float32)
    y = rng.normal(size=shapes[1]).astype(np.float32)
    w = (rng.uniform(size=shapes[0][0]) < 0.7).astype(np.float32)
    for jfn, tfn, extra in ((jch.masked_chamfer_l2, masked_chamfer_l2, (w,)),
                            (jch.chamfer_l2, chamfer_l2, ())):
        lj, (gxj, gyj) = jax.jit(jax.value_and_grad(
            lambda a, c: jfn(a, c, *map(jnp.asarray, extra)), argnums=(0, 1)))(x, y)
        xt = torch.from_numpy(x).requires_grad_()
        yt = torch.from_numpy(y).requires_grad_()
        lt = tfn(xt, yt, *map(torch.from_numpy, extra))
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gyj), rtol=1e-5, atol=1e-7)


def test_plain_tiled_chamfer_matches_jax():
    """At a shape inside the tiled kernel's gate (600 x 700 >= 512^2), on a
    CPU tensor through the plain version: indices equal to the XLA path's
    and to the Pallas kernel's in interpret mode, distances to 1e-5 of the
    largest (an expansion distance near zero carries the rounding of its
    three terms), a duplicated target resolved to the first index, and
    ``chamfer_l2`` and its gradients at that shape."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 600, 3)).astype(np.float32)
    y = rng.normal(size=(2, 700, 3)).astype(np.float32)
    y[1, 650] = y[1, 12]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert not use_tiled_kernel(xt, 700)            # a CPU tensor: gate closed
    for a, b in ((x, y), (y, x)):
        dj, ij = jch._nn_half_xla(jnp.asarray(a), jnp.asarray(b))
        with pltpu.force_tpu_interpret_mode():
            _, ip = jch._nn_half_pallas(jnp.asarray(a), jnp.asarray(b))
        dt, it = nn_half_tiled(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=1e-5 * float(np.asarray(dj).max()))
        assert float(dt.min()) >= 0.0
    lj, (gxj, gyj) = jax.jit(jax.value_and_grad(jch.chamfer_l2, argnums=(0, 1)))(x, y)
    xt.requires_grad_()
    yt.requires_grad_()
    lt = chamfer_l2(xt, yt)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gyj), rtol=1e-5, atol=1e-7)
