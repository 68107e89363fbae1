"""Every patch-corruption family of the PyTorch port (``PATCH_SUPPORTED``)
against the JAX package's ``corrupt_patches`` on the CPU, on the same draws
(replayed from the JAX key, ``tests/_jax_draws.py``), and the refusal of a
name outside it in both packages.

Tolerance: 1e-5 absolute and relative (a 3 x 3 product on the patches;
read: at most 1e-6); the 'scan' and 'dropout_global' selections exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_draws as jd
from point_dae_tpu.data import corruptions_patch as jcp

from point_dae_torch.data import corruptions_patch as tcp

from _torch_files import one_torch_thread  # noqa: F401

B, G, S = 4, 8, 32
FAMILIES = sorted(jcp.PATCH_SUPPORTED)
CASES = {**{f: (f,) for f in FAMILIES},
         "affine_r3_then_scan": ("affine_r3", "scan", "Drop-Patch"),
         "repeated": ("jitter", "add_local", "jitter", "dropout_global")}


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    center = rng.normal(size=(B, G, 3)).astype(np.float32)
    neigh = center[:, :, None] + 0.1 * rng.normal(size=(B, G, S, 3)).astype(np.float32)
    key = jax.random.key(7)
    out = jax.device_get(jax.jit(lambda n, c: {
        case: (jcp.corrupt_patches(key, n, c, t), jd.patch_draws_raw(key, t, (B, G, S)))
        for case, t in CASES.items()})(neigh, center))
    return neigh, center, out


def test_patch_supported_matches_jax():
    assert tcp.PATCH_SUPPORTED == jcp.PATCH_SUPPORTED


@pytest.mark.parametrize("case", list(CASES))
def test_corrupt_patches_matches_jax(case):
    types = CASES[case]
    neigh, center, out = _inputs()
    (want_n, want_c), raw = out[case]
    draws = jd.to_patch_draws(types, raw)
    got_n, got_c = tcp.corrupt_patches(torch.from_numpy(neigh), torch.from_numpy(center),
                                       types, draws)
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5, atol=1e-5)
    if case in ("clean", "Drop-Patch"):
        np.testing.assert_array_equal(got_n.numpy(), neigh)
    else:
        assert np.abs(got_n.numpy() - neigh).max() > 1e-3
    # the port's own draws run the same family at the same shapes
    g = torch.Generator().manual_seed(0)
    own_n, own_c = tcp.corrupt_patches(torch.from_numpy(neigh), torch.from_numpy(center),
                                       types, generator=g)
    assert own_n.shape == (B, G, S, 3) and own_c.shape == (B, G, 3)
    assert torch.isfinite(own_n).all()


@pytest.mark.parametrize("name", ["dropout_local_c1d1", "jitter_p01", "affine_r5"])
def test_unsupported_name_is_refused_in_both(name):
    neigh = np.zeros((B, G, S, 3), np.float32)
    center = np.zeros((B, G, 3), np.float32)
    with pytest.raises(NotImplementedError, match=name):
        jax.eval_shape(lambda n, c: jcp.corrupt_patches(jax.random.key(0), n, c,
                                                        ("Drop-Patch", name)),
                       jnp.asarray(neigh), jnp.asarray(center))
    with pytest.raises(NotImplementedError, match=name):
        tcp.sample_patch_draws(("Drop-Patch", name), B, G, S, None, "cpu")
    with pytest.raises(NotImplementedError, match=name):
        tcp.corrupt_patches(torch.from_numpy(neigh), torch.from_numpy(center),
                            ("clean", name), [None, None])
