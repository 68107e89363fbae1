"""Both chamfer kernels' pair entries (losses/chamfer.py:nn_half_small_pair,
nn_half_tiled_pair: both directions of an nn_distance call in one launch on
the card) and their launch plans, on the CPU: the entries against the two
plain halves and against the JAX package's Pallas kernels in interpret mode;
the plans' coverage and shared memory over the gates' shapes."""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from point_dae_tpu.losses import chamfer as jch

from point_dae_torch.losses import chamfer
from point_dae_torch.utils import kernels

from _torch_files import one_torch_thread  # noqa: F401

BLOCK_SMEM = 232448             # a block's shared memory on the H100 (227 KB)


def _cloud_pair(rng, B, N, M, scale=1.0):
    """x (B, N, 3), y (B, M, 3) with a duplicated target, an exact hit on it
    and an exact hit elsewhere: ties resolve to the first index."""
    x = (scale * rng.normal(size=(B, N, 3))).astype(np.float32)
    y = (scale * rng.normal(size=(B, M, 3))).astype(np.float32)
    y[:, M - 1] = y[:, 1]                         # duplicated target
    x[:, 0] = y[:, 1]                             # an exact hit on both copies
    x[:, N // 2] = y[:, M // 2]                   # an exact hit
    return x, y


@pytest.mark.parametrize("N,M", [(12, 8), (5, 17)])
def test_patch_pair_matches_plain_halves_and_pallas(N, M):
    """nn_half_small_pair on CPU tensors equals the two plain halves bit for
    bit, and the Pallas kernel in interpret mode both ways: indices and
    nearest points equal, distances within 1e-6 (XLA's CPU code may contract
    the distance into fused multiply-adds)."""
    rng = np.random.default_rng(N * 100 + M)
    x, y = _cloud_pair(rng, 37, N, M)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = chamfer.nn_half_small_pair(xt, yt)
    want = chamfer.nn_half_small_plain(xt, yt) + chamfer.nn_half_small_plain(yt, xt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[1][0, 0]) == 1                 # the first copy of the duplicate
    for (a, b), (d, i, n) in zip(((x, y), (y, x)), (got[:3], got[3:])):
        with pltpu.force_tpu_interpret_mode():
            dj, ij, nj = jch._nn_half_small_pallas(jnp.asarray(a), jnp.asarray(b),
                                                   lane_tile=16)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6)


def test_tiled_pair_matches_plain_halves_and_pallas():
    """nn_half_tiled_pair on CPU tensors at a shape inside the tiled gate
    (512 x 520 >= 512^2) equals the two plain halves bit for bit, and the
    Pallas kernel in interpret mode both ways: indices equal, distances
    within 1e-5 of the largest (an expansion distance near zero carries the
    rounding of its three terms), none below zero."""
    rng = np.random.default_rng(15)
    x, y = _cloud_pair(rng, 1, 512, 520)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = chamfer.nn_half_tiled_pair(xt, yt)
    want = chamfer.nn_half_tiled_plain(xt, yt) + chamfer.nn_half_tiled_plain(yt, xt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[1][0, 0]) == 1
    for (a, b), (d, i) in zip(((x, y), (y, x)), (got[:2], got[2:])):
        with pltpu.force_tpu_interpret_mode():
            dj, ij = jch._nn_half_pallas(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=0,
                                   atol=1e-5 * float(np.asarray(dj).max()))
        assert float(d.min()) >= 0.0


class _Set:
    """A stand-in for a CUDA tensor of shape (B, n, 3): the gates read only
    the device type and the shape."""

    def __init__(self, B, n):
        self.device, self.shape = torch.device("cuda"), (B, n, 3)


@pytest.mark.parametrize("B", [1, 4095, 4096, 13056])
def test_both_gates_are_symmetric_in_n_and_m(B):
    """nn_distance's forward sends both directions to one pair entry: it
    needs each gate to give the same answer for (N, M) and (M, N)."""
    sizes = (1, 17, 32, 36, 64, 65, 511, 512, 513, 1024, 4096, 262144)
    for n in sizes:
        for m in sizes:
            for gate in (chamfer.use_small_kernel, chamfer.use_tiled_kernel):
                assert gate(_Set(B, n), m) == gate(_Set(B, m), n), (gate.__name__, n, m)
    assert chamfer.use_small_kernel(_Set(13056, 36), 32)
    assert chamfer.use_tiled_kernel(_Set(128, 1024), 1024)


def test_nn_distance_on_cpu_takes_the_xla_halves():
    """On CPU tensors both gates are closed: nn_distance's forward gives the
    expansion halves of the XLA path, both directions."""
    rng = np.random.default_rng(16)
    x, y = (torch.from_numpy(a) for a in _cloud_pair(rng, 40, 36, 32))
    d1, d2, i1, i2 = chamfer.nn_distance(x, y)
    for (d, i), (a, b) in zip(((d1, i1), (d2, i2)), ((x, y), (y, x))):
        dw, iw = chamfer._nn_half_xla(a, b)
        assert torch.equal(i, iw) and torch.equal(d, dw.clamp_min(0.0))


def _gate_shapes():
    """(N, M) over the tiled gate (N M >= 512^2), N and M from 1 to 2^18,
    at its edges and at the paths' sizes."""
    sizes = (1, 2, 3, 64, 100, 511, 512, 513, 1023, 1024, 2049, 4096, 16385, 65536, 262143,
             262144)
    return [(n, m) for n in sizes for m in sizes if n * m >= 512 * 512]


@functools.lru_cache(maxsize=None)
def _rows_written_once(plan, rows: int) -> bool:
    """Every row of ``rows`` is held by exactly one (block, thread, r) slot
    of ``plan`` that stores it (one check a distinct plan and row count:
    the shapes of the gate share them)."""
    held = plan.rows_of(rows)
    written = held[held < rows]
    return bool((torch.bincount(written, minlength=rows) == 1).all())


@pytest.mark.parametrize("B", [1, 128])
def test_tiled_plan_covers_rows_and_columns_once(B):
    """Over the tiled gate's shapes: every row of both directions is written
    by one block, each group's column range is contiguous and the ranges
    cover the targets once, the plan takes rows a thread and groups the
    kernel is built for, and its shared memory fits a block."""
    for N, M in _gate_shapes():
        plan = chamfer.tiled_plan(B, N, M)
        assert plan.rows in chamfer.TILED_ROWS and plan.warps % plan.groups == 0
        assert 1 <= plan.threads <= 256 and plan.piece >= 1
        assert plan.smem() <= BLOCK_SMEM, (N, M, plan)
        for rows, cols in ((N, M), (M, N)):
            assert _rows_written_once(plan, rows), (N, M, plan)
            ranges = plan.ranges(cols)
            assert ranges[0][0] == 0 and ranges[-1][1] == cols
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(lo <= hi for lo, hi in ranges)
        assert plan.blocks(B, N, M) == B * (len(plan.rows_of(N)) + len(plan.rows_of(M)))


def test_tiled_plan_fills_the_card_at_the_dgcnn_step():
    """At the DGCNN step's 128 x 1024 x 1024 the plan gives every SM of the
    H100 a block and the warps it asks for, in one column group (more
    groups were slower on the card: tools/chamfer_ablation.py)."""
    plan = chamfer.tiled_plan(128, 1024, 1024, 132)
    assert plan.groups == 1 and plan.piece == 1024
    assert plan.blocks(128, 1024, 1024) >= 132
    assert plan.blocks(128, 1024, 1024) * plan.warps >= chamfer.TILED_WARPS_AN_SM * 132


@pytest.mark.parametrize("P", [4096, 4097, 13056])
@pytest.mark.parametrize("N,M", [(36, 32), (32, 36), (1, 64), (64, 1), (64, 64), (17, 5)])
def test_patch_plan_covers_every_item_once(P, N, M):
    """Every (patch, direction, query) item of the patch kernel under its
    plan is stored by one task, the plan's shared memory fits a block, and
    a block holds one round of tasks."""
    plan = chamfer.patch_plan(N, M)
    items = chamfer.patch_tasks(plan, P, N, M)
    p, d, q = items.unbind(1)
    assert bool(((p >= 0) & (p < P) & (q >= 0) & (q < torch.where(d == 1, M, N))).all())
    key = torch.where(d == 1, P * N + p * M + q, p * N + q)      # one slot an item
    assert torch.equal(torch.sort(key).values, torch.arange(P * (N + M)))
    assert plan.smem(N, M) <= BLOCK_SMEM
    tasks = plan.patches * (chamfer.patch_groups(N) + chamfer.patch_groups(M))
    assert tasks <= plan.threads and plan.threads % 32 == 0


def test_plan_constants_match_the_kernel_source():
    """The chunk of the tiled kernel and the queries a thread of the patch
    kernel, as losses/chamfer.py counts them, are csrc/chamfer.cu's."""
    src = open(f"{kernels.CSRC}/chamfer.cu").read()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == chamfer.TILED_CHUNK
    assert int(re.search(r"constexpr int kQueries = (\d+);", src).group(1)) == \
        chamfer.PATCH_QUERIES
    assert [n for n in re.findall(r"case (\d+): err = launch_tiled", src)] == \
        [str(r) for r in chamfer.TILED_ROWS]
