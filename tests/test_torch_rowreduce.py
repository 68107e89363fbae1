"""The launch plans and the counting sort's layout of the two row reductions
on the CPU: the EdgeConv aggregate (``ops/edgeconv.py:aggregate_plan``, the
staged form of ``csrc/edgeconv.cu`` or its L2 form) and the row scatter-add
(``ops/gather.py:scatter_plan``; ``scatter_lists_plain``, the scratch the
kernel's counting sort leaves, held against lists built by a stable
argsort). The plain versions are held against the JAX functions in
``test_torch_knn.py``, ``test_torch_partseg.py`` and
``test_torch_geometry.py``."""
import numpy as np
import pytest
import torch

from point_dae_torch.ops import edgeconv, gather

SMS = edgeconv.H100_SMS
# the fused EdgeConv's and aggregate_from_idx's shapes on the paths: the DGCNN
# pretrain step (and MaskFeat, the dropout configs), fine-tune B and C, the
# card-against-CPU checks at batch 8, the kernels phase's (4, 4096)
PATH_SHAPES = [(128, 1024, C) for C in (64, 128, 256)] + [
    (32, 1024, C) for C in (64, 128, 256)] + [(32, 2048, 64), (32, 2048, 128),
                                             (8, 1024, 64), (4, 4096, 64)]
LIMIT = edgeconv.BLOCK_SMEM // 16          # the last N a 4-channel slice takes


@pytest.mark.parametrize("N", [1, 2, 20, 1023, 1024, 2048, 4096, 8192, LIMIT, LIMIT + 1,
                               20000])
def test_aggregate_plan_gives_every_shape_a_form_that_fits(N):
    for B in (1, 4, 128):
        for C in (1, 3, 4, 5, 64, 66, 128, 256, 1152):
            p = edgeconv.aggregate_plan(B, N, C, SMS)
            assert p.chunks >= 1 and p.chunks <= max(N, 1)
            if N > LIMIT:
                assert p == edgeconv.AggPlan(0, 1), (B, N, C)
                continue
            assert p.form == "staged" and p.lanes in edgeconv.AGG_LANES, (B, N, C, p)
            assert p.smem(N) <= edgeconv.BLOCK_SMEM
            # no slice wider than C needs (one of four channels is the least)
            assert p.lanes == 1 or 4 * p.lanes < C + 4
            # a chunk keeps a whole pass of the block's rows
            assert -(-N // p.chunks) >= min(N, p.warps * 32 // p.lanes) or \
                p.chunks == 1


@pytest.mark.parametrize("B,N,C", PATH_SHAPES)
def test_path_shapes_take_the_staged_form_over_the_whole_card(B, N, C):
    """At least a block an SM, or, where B times the slices falls short, as
    many row chunks as one wave of the card holds: each chunk copies the
    cloud's slice again, and at (4, 4096) 128 blocks ran faster than 256
    (tools/rowreduce_ablation.py on the H100, PERF.md). 32 warps an SM."""
    p = edgeconv.aggregate_plan(B, N, C, SMS)
    assert p.form == "staged"
    per_sm = min(edgeconv.blocks_per_sm(p.smem(N)), 32 // p.warps)
    assert per_sm * p.warps == 32
    blocks = p.blocks(B, N, C)
    rows_a_pass = p.warps * 32 // p.lanes
    assert blocks >= SMS or 2 * blocks > SMS * per_sm or -(-N // (2 * p.chunks)) < rows_a_pass
    assert blocks >= SMS // 2


def test_aggregate_plan_keys():
    """The plans the chip runs timed, pinned: a 32-channel slice at 1024
    points, 16 at 2048, 8 at 4096 (128 KB each, one block of 32 warps an
    SM), and the L2 form one point past a 4-channel slice's limit."""
    assert edgeconv.aggregate_plan(128, 1024, 64, SMS) == edgeconv.AggPlan(8, 1, 32)
    assert edgeconv.aggregate_plan(32, 2048, 64, SMS) == edgeconv.AggPlan(4, 1, 32)
    assert edgeconv.aggregate_plan(4, 4096, 64, SMS) == edgeconv.AggPlan(2, 4, 32)
    assert edgeconv.aggregate_plan(2, LIMIT, 64, SMS).lanes == 1
    assert edgeconv.aggregate_plan(2, LIMIT + 1, 64, SMS).form == "L2"
    assert edgeconv.AggPlan(0, 1).blocks(4, 4096, 64) == 4 * 4096 // edgeconv.L2_WARPS


def test_aggregate_wrapper_refuses_a_plan_that_does_not_fit():
    U = torch.zeros((1, LIMIT + 1, 8))
    with pytest.raises(NotImplementedError):
        edgeconv._plan_for(U, edgeconv.AggPlan(1, 1))
    with pytest.raises(NotImplementedError):
        edgeconv._plan_for(U, edgeconv.AggPlan(3, 1))
    assert edgeconv._plan_for(U, edgeconv.AggPlan(0, 1)).form == "L2"


# (B, Q, C, elem bytes, alignment) -> the plan
SCATTER_PATHS = [((16, 6144, 1152, 4, 256), gather.ScatterPlan(8, 4, 32)),
                 ((16, 40960, 64, 4, 256), gather.ScatterPlan(8, 4, 16)),
                 ((16, 40960, 64, 2, 256), gather.ScatterPlan(8, 8, 8)),
                 ((8, 40960, 64, 4, 256), gather.ScatterPlan(16, 4, 16))]


@pytest.mark.parametrize("args,want", SCATTER_PATHS)
def test_scatter_plan_at_the_partseg_shapes(args, want):
    p = gather.scatter_plan(*args, sms=SMS)
    assert p == want
    B, Q = args[:2]
    assert abs(B * p.segs - SMS) <= B / 2      # the sort spreads over the card
    assert -(-Q // p.segs) >= gather.MIN_SEG


@pytest.mark.parametrize("C", [1, 3, 32, 36, 64, 66, 96, 1152])
@pytest.mark.parametrize("elem", [4, 2])
def test_scatter_plan_loads_divide_c_and_the_alignment(C, elem):
    for B, Q in ((1, 1), (16, 100), (2, 6144), (16, 40960), (256, 40960)):
        for align in (2, 4, 8, 16, 256):
            if align < elem:
                continue
            p = gather.scatter_plan(B, Q, C, elem, align, SMS)
            assert 1 <= p.segs <= gather.MAX_SEGS
            assert p.segs == 1 or -(-Q // p.segs) >= gather.MIN_SEG
            assert C % p.vec == 0 and align % (p.vec * elem) == 0 and p.vec * elem <= 16
            assert p.lanes in (1, 2, 4, 8, 16, 32)
            assert p.lanes * p.vec >= C or p.lanes == 32
            assert p.lanes == 1 or (p.lanes // 2) * p.vec < C


# (B, Q, N, segs): ragged Q, one row, a single segment, more segments than fit
LIST_CASES = [(2, 1000, 37, 7), (3, 513, 1, 4), (1, 40, 5, 1), (2, 130, 64, 16),
              (1, 0, 3, 2), (2, 6144, 128, 12)]


def _idx(B, Q, N, seed, outside=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, size=(B, Q))
    if Q:
        idx[:, ::5] = 0                                 # a hub row
        if outside:
            idx[:, 1::11] = -1 - idx[:, 1::11]           # outside [0, N): add nothing
            idx[:, 2::13] = N + idx[:, 2::13]
    return torch.from_numpy(idx).int()


@pytest.mark.parametrize("B,Q,N,segs", LIST_CASES)
def test_sort_scratch_holds_each_rows_contributors_in_ascending_q(B, Q, N, segs):
    idx = _idx(B, Q, N, Q + N)
    counts, start, order = gather.scatter_lists_plain(idx, N, segs)
    assert counts.shape == (B, segs, N) and start.shape == (B, N + 1)
    assert order.shape == (B, Q)
    assert B * (counts[0].numel() + start[0].numel() + order[0].numel()) == \
        gather.scatter_work_ints(B, Q, N, segs)
    seg = -(-Q // segs) if Q else 1
    valid = (idx >= 0) & (idx < N)
    for b in range(B):
        ref = torch.argsort(torch.where(valid[b], idx[b], N), stable=True)
        n_valid = int(valid[b].sum())
        assert int(start[b, 0]) == 0 and int(start[b, N]) == n_valid
        assert torch.equal(order[b, :n_valid], ref[:n_valid].int())
        assert bool((order[b, n_valid:] == -1).all())
        for m in range(N):
            lst = order[b, start[b, m]:start[b, m + 1]].long()
            assert torch.equal(lst, torch.nonzero(idx[b] == m).flatten())
            for s in range(segs):
                assert int(counts[b, s, m]) == int((idx[b, s * seg:(s + 1) * seg] == m).sum())


@pytest.mark.parametrize("B,Q,N,segs", LIST_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sums_over_the_lists_equal_the_plain_scatter_bit_for_bit(B, Q, N, segs, dtype):
    """The sum pass written out: each row's list walked in order, one add
    an entry, against ``scatter_rows_add_plain`` (scatter_add_ on the CPU)."""
    idx = _idx(B, Q, N, 7 * Q + N)
    C = 6
    g = torch.from_numpy(np.random.default_rng(Q).normal(size=(B, Q, C)).astype(np.float32))
    g = g.to(dtype)
    _, start, order = gather.scatter_lists_plain(idx, N, segs)
    start, order = start.long(), order.long()
    count = start[:, 1:] - start[:, :-1]
    acc = torch.zeros((B, N, C))
    bi = torch.arange(B)[:, None]
    for p in range(int(count.max())):
        live = (count > p)[..., None]
        q = order.gather(1, (start[:, :-1] + p).clamp_max(max(Q - 1, 0)))
        acc = torch.where(live, acc + g.float()[bi, q.clamp_min(0)], acc)
    assert torch.equal(acc, gather.scatter_rows_add_plain(idx, g, N))
