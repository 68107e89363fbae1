"""The key gather from a mask (``ops/gather.py:gather_by_mask`` and its
plain twin) against the JAX package on the CPU: the plain twin against
``gather_by_key_small_c_pallas`` in interpret mode with the keys built as
``point_dae_tpu/ops/geometry.py:329-330`` builds them; the uniform-to-rank
rounding the kernel does, written out in numpy, against the chain the
masked resample ran before; the masked resample's argsort-pack layout on
the CPU against ``jops.resample_batch``; the block width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu import ops as jops
from point_dae_tpu.ops.pallas_scatter import gather_by_key_small_c_pallas

from point_dae_torch.ops import gather
from point_dae_torch.ops.geometry import resample_batch

from _torch_files import one_torch_thread  # noqa: F401


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _mask(rng, B, N):
    """A random mask: cloud 1 with no valid point, cloud 2 with one."""
    mask = rng.random(size=(B, N)) > 0.5
    mask[1] = False
    mask[2] = False
    mask[2, N // 3] = True
    return mask


def _kernel_ranks(mask: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The kernel's rounding (csrc/gather.cu:draw_rank), in numpy:
    min(trunc(u * float(max(cnt, 1))), max(cnt, 1) - 1), the product in f32."""
    c = np.maximum(mask.sum(1), 1).astype(np.int64)[:, None]
    prod = (u.astype(np.float32) * c.astype(np.float32)).astype(np.float32)
    return np.minimum(np.trunc(prod).astype(np.int64), c - 1)


@pytest.mark.parametrize("draws", ["ranks", "uniforms"])
def test_mask_plain_twin_matches_pallas_interpret(draws):
    """``gather_by_mask_plain`` against the Pallas kernel on the keys of
    ``geometry.py:329-330`` (rank = cumsum(mask) - 1, -1 off the mask): bit
    for bit, the cloud with no valid point all zeros; ranks past a cloud's
    count (cloud 0) give zeros in both."""
    rng = np.random.default_rng(1)
    B, N, Q = 4, 256, 192
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = _mask(rng, B, N)
    u = rng.random(size=(B, Q)).astype(np.float32)
    ranks = _kernel_ranks(mask, u).astype(np.int32)
    if draws == "ranks":
        ranks[0, :7] = mask[0].sum() + np.arange(7)
    m = jnp.asarray(mask)
    rank = jnp.cumsum(m.astype(jnp.int32), axis=1) - 1
    keys = jnp.where(m, rank, -1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gather_by_key_small_c_pallas(jnp.asarray(x), keys,
                                                       jnp.asarray(ranks), tq=64))
    d = _t(ranks) if draws == "ranks" else _t(u)
    got = gather.gather_by_mask_plain(_t(x), _t(mask), d).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and got[3].any()
    np.testing.assert_array_equal(gather.gather_by_mask(_t(x), _t(mask), d).numpy(), want)


def test_uniform_ranks_round_as_the_previous_chain():
    """The kernel's uniform-to-rank rounding, in numpy, against
    ``ranks_from_uniforms`` and the chain the resample ran before it
    (``(draws * cnt).long().clamp_max(cnt - 1)``): bit for bit for every
    count from 1 to 12288 at u just under 1.0, at 0, at 1.0 (where the
    clamp holds the rank below the count) and at random u, and for
    a cloud with no valid point (rank 0, which matches no key: zeros)."""
    N = 12288
    cnt = np.arange(1, N + 1)
    mask = np.arange(N)[None, :] < cnt[:, None]
    rng = np.random.default_rng(2)
    u = rng.random(size=(N, 6)).astype(np.float32)
    u[:, 0] = np.nextafter(np.float32(1.0), np.float32(0.0))
    u[:, 1] = 0.0
    u[:, 2] = np.float32(1.0 - 2.0 ** -23)
    u[:, 3] = 1.0                                            # only the clamp keeps it in range
    mt, ut = _t(mask), _t(u)
    c = mt.sum(1).clamp_min(1)[:, None]
    previous = (ut * c).long().clamp_max(c - 1)
    got = gather.ranks_from_uniforms(mt, ut)
    want = _kernel_ranks(mask, u)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(previous.numpy(), want)
    assert (want[:, 0] == cnt - 1).all() and (want[:, 3] == cnt - 1).all()
    assert (want < cnt[:, None]).all()
    empty = np.zeros((2, 64), dtype=bool)
    empty[1, 9] = True
    ue = np.full((2, 5), np.nextafter(np.float32(1.0), np.float32(0.0)), dtype=np.float32)
    np.testing.assert_array_equal(_kernel_ranks(empty, ue), np.zeros((2, 5)))
    x = _t(np.ones((2, 64, 3), dtype=np.float32))
    out = gather.gather_by_mask_plain(x, _t(empty), _t(ue))
    assert not out[0].any() and out[1].all()


@pytest.mark.parametrize("seed", [3, 4])
def test_resample_batch_on_cpu_keeps_the_argsort_pack(seed):
    """On the CPU ``resample_batch`` keeps the argsort-pack layout:
    bit for bit with ``jops.resample_batch`` from its own integer draws, and
    from uniforms the same bits as from the ranks they round to (a cloud
    with no valid point gives its first point)."""
    rng = np.random.default_rng(seed)
    B, N, num = 4, 96, 40
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = _mask(rng, B, N)
    key = jax.random.key(seed)
    cnt = np.maximum(mask.sum(1), 1)
    draw = np.asarray(jax.random.randint(key, (B, num), 0, jnp.asarray(cnt)[:, None]))
    want = np.asarray(jops.resample_batch(key, jnp.asarray(pts), jnp.asarray(mask), num))
    got = resample_batch(_t(pts), _t(mask), num, draws=_t(draw)).numpy()
    np.testing.assert_array_equal(got, want)
    u = rng.random(size=(B, num)).astype(np.float32)
    from_u = resample_batch(_t(pts), _t(mask), num, draws=_t(u)).numpy()
    from_r = resample_batch(_t(pts), _t(mask), num, draws=_t(_kernel_ranks(mask, u))).numpy()
    np.testing.assert_array_equal(from_u, from_r)
    assert (from_u[1] == pts[1, 0]).all()
    valid = [0, 2, 3]
    np.testing.assert_array_equal(
        from_u[valid], gather.gather_by_mask_plain(_t(pts), _t(mask), _t(u)).numpy()[valid])


@pytest.mark.parametrize("Q,threads", [(1024, 1024), (2048, 1024), (4000, 1024), (700, 704),
                                       (100, 128), (1, 128), (300, 320)])
def test_key_gather_threads(Q, threads):
    """One block a cloud, a thread a draw: the draws rounded up to a warp,
    128 to 1024 threads (the dropouts' 1024 draws: 1024)."""
    assert gather.key_gather_threads(Q) == threads
