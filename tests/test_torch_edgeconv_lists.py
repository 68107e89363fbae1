"""The EdgeConv backward's contributor lists (``ops/edgeconv.py:
contributor_lists_plain``, the order ``csrc/edgeconv.cu`` builds by a
counting sort) on the CPU: each target row's list holds the entries
i k + r with idx[i, r] equal to it, in ascending (i, r), and sums over the
lists in that order, as the kernel's sum pass takes them, equal the plain
backwards bit for bit."""
import numpy as np
import pytest
import torch

from point_dae_torch.ops import edgeconv

from _torch_files import one_torch_thread  # noqa: F401

# (B, N, Cf, C, k)
SHAPES = [(2, 100, 3, 8, 7), (3, 64, 5, 12, 20), (1, 300, 16, 4, 33), (2, 40, 3, 6, 40)]


def _inputs(B, N, Cf, C, k, seed):
    """A kNN idx over clouds with duplicated points (distance ties), U of
    bf16 values duplicated the same way (value ties), four cotangents."""
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(B, N, Cf)).astype(np.float32)
    U = rng.normal(size=(B, N, C)).astype(np.float32)
    xf[:, N - 8:] = xf[:, :8]
    U[:, N - 8:] = U[:, :8]
    U = torch.from_numpy(U).bfloat16().float()
    cots = [torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)) for _ in range(4)]
    xf = torch.from_numpy(xf)
    return xf, U, edgeconv.knn_select_plain(xf, k), cots


@pytest.mark.parametrize("B,N,Cf,C,k", SHAPES)
def test_lists_hold_each_targets_contributors_in_source_order(B, N, Cf, C, k):
    _, _, idx, _ = _inputs(B, N, Cf, C, k, 0)
    start, entries = edgeconv.contributor_lists_plain(idx)
    assert start.dtype == torch.int32 and entries.dtype == torch.int32
    assert start.shape == (B, N + 1) and entries.shape == (B, N * k)
    assert torch.equal(start[:, 0], torch.zeros(B, dtype=torch.int32))
    assert torch.equal(start[:, -1], torch.full((B,), N * k, dtype=torch.int32))
    flat = idx.reshape(B, N * k)
    for b in range(B):
        assert torch.equal(torch.sort(entries[b].long()).values, torch.arange(N * k))
        for j in range(N):
            lst = entries[b, start[b, j]:start[b, j + 1]].long()
            assert bool((flat[b, lst] == j).all())
            assert bool((lst[1:] > lst[:-1]).all())          # ascending (i, r)
            assert len(lst) == int((flat[b] == j).sum())
    # some target is named by more rows than a row names (at k == N, by all)
    assert int((start[:, 1:] - start[:, :-1]).max()) > k or k == N


def _sums_over_lists(U, idx, t, gs1, gs2):
    """The kernel's sum pass written out: target j's list walked in order,
    acc += t, s1 += gs1, s2 += gs2, then (acc + s1) + (2 U) s2. ``t`` (B, N,
    k, C) is the (gM, gm) term of each entry."""
    B, N, k = idx.shape
    start, entries = edgeconv.contributor_lists_plain(idx)
    start, entries = start.long(), entries.long()
    count = start[:, 1:] - start[:, :-1]
    acc = torch.zeros_like(U)
    s1 = torch.zeros_like(U)
    s2 = torch.zeros_like(U)
    tf = t.reshape(B, N * k, -1)
    bi = torch.arange(B)[:, None]
    for p in range(int(count.max())):
        live = (count > p)[..., None]
        e = entries.gather(1, (start[:, :-1] + p).clamp_max(N * k - 1))
        i = e // k
        acc = torch.where(live, acc + tf[bi, e], acc)
        s1 = torch.where(live, s1 + gs1[bi, i], s1)
        s2 = torch.where(live, s2 + gs2[bi, i], s2)
    return (acc + s1) + (2.0 * U) * s2


@pytest.mark.parametrize("B,N,Cf,C,k", SHAPES)
def test_sums_over_the_lists_equal_the_plain_backwards_bit_for_bit(B, N, Cf, C, k):
    xf, U, idx, (gM, gm, gs1, gs2) = _inputs(B, N, Cf, C, k, 1)
    M, m, _, _, rM, rm = edgeconv.aggregate_plain(U, idx)
    rounds = torch.arange(k)[None, None, :, None]
    zero = torch.zeros(())
    t_first = (torch.where(rM[:, :, None] == rounds, gM[:, :, None], zero)
               + torch.where(rm[:, :, None] == rounds, gm[:, :, None], zero))
    want = edgeconv.bwd_first_plain(U, idx, rM, rm, gM, gm, gs1, gs2)
    assert torch.equal(_sums_over_lists(U, idx, t_first, gs1, gs2), want)

    g = edgeconv._gather_neighbours(U, idx)
    isM, ism = g == M[:, :, None], g == m[:, :, None]
    assert bool((isM.sum(2) > 1).any())                      # value ties split
    wM = gM / isM.sum(2).clamp_min(1).float()
    wm = gm / ism.sum(2).clamp_min(1).float()
    t_split = (torch.where(isM, wM[:, :, None], zero) + torch.where(ism, wm[:, :, None], zero))
    want = edgeconv.bwd_split_plain(U, idx, M, m, gM, gm, gs1, gs2)
    assert torch.equal(_sums_over_lists(U, idx, t_split, gs1, gs2), want)


def test_lists_of_any_idx_are_a_stable_sort_by_target():
    """Rows that name a target twice, and targets no row names: the lists
    are still a stable sort of each cloud's entries by target."""
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, 9, size=(2, 12, 5)).astype(np.int32))
    start, entries = edgeconv.contributor_lists_plain(idx)
    flat = idx.reshape(2, -1).long()
    for b in range(2):
        want = sorted(range(60), key=lambda e: (int(flat[b, e]), e))
        assert entries[b].tolist() == want
        assert start[b].tolist() == [0] + np.cumsum(np.bincount(flat[b], minlength=12)).tolist()
