"""Fused EdgeConv neighbour aggregate (port of
``point_dae_tpu/ops/pallas_edgeconv.py``).

``knn_aggregate(U, xf, k)`` selects each point's k nearest neighbours over
``xf`` (unclamped expansion distances, the first index on ties, the point
itself included) and returns, over the selected rows of ``U`` in distance
order, ``(M, m, S1, S2, idx)`` = max, min, sum, sum of squares and the
neighbour indices. Only ``U`` gets a gradient. ``grad_mode`` routes the
max / min cotangents: ``first`` to the first neighbour in distance order
that attains the extremum, ``split`` equally among the neighbours whose
value equals it.

``aggregate_from_idx(U, idx)`` is the same aggregate over a given
distance-ordered idx (``pallas_edgeconv.aggregate_from_idx``: the hybrid
EdgeConv, whose kNN runs outside), with the same two backwards.

On a CUDA tensor the forwards and both backwards are the kernels of
``csrc/edgeconv.cu`` (N <= 4096, the whole JAX gate); on a CPU tensor their
plain PyTorch versions below, which repeat the kernels' arithmetic
(distances summed in channel order, aggregates in round order, each
backward's three sums in (source, round) order: the order of the
contributor lists the backward kernels build, ``contributor_lists_plain``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import kernels
from .tiled_knn import knn_plain

_INF = 1e30

# csrc/edgeconv.cu's aggregate: the staged form copies a cloud's slice of U
# (N x 4 lanes channels f32) into a block's shared memory; lanes 0 is the
# L2 form, for clouds where not even a slice of four channels fits.
AGG_LANES = (8, 4, 2, 1)        # lanes a row, a float4 each: slices of 32, 16, 8, 4
AGG_WARPS = (8, 16, 32)         # warps a block the kernel is built for
L2_WARPS = 8                    # the L2 form's warps a block, a row each
BLOCK_SMEM = 232448             # a block's shared memory on the H100 (227 KB)
SM_SMEM = 233472                # an SM's (228 KB), of which a block reserves 1 KB
H100_SMS = 132


class AggPlan(NamedTuple):
    """How the aggregate launches: ``lanes`` lanes a row (a slice of
    ``4 lanes`` channels a block) in ``chunks`` row chunks a cloud, blocks of
    ``warps`` warps; or with ``lanes`` 0 the L2 form (a warp a row)."""
    lanes: int
    chunks: int
    warps: int = 8

    @property
    def form(self) -> str:
        return "staged" if self.lanes else "L2"

    def smem(self, N: int) -> int:
        """Dynamic shared memory a block of this plan takes at N points."""
        return N * 16 * self.lanes

    def blocks(self, B: int, N: int, C: int) -> int:
        if not self.lanes:
            return -(-B * N // L2_WARPS)
        return B * self.chunks * -(-C // (4 * self.lanes))


def blocks_per_sm(smem: int) -> int:
    return SM_SMEM // (smem + 1024)


def aggregate_plan(B: int, N: int, C: int, sms: int = H100_SMS) -> AggPlan:
    """The staged form with the widest slice (no wider than C needs) that
    fits a block; 32 warps an SM, as one block or two (64 registers a
    thread leave no room for more); then row chunks doubled while the
    blocks still fit one wave of the card and a chunk keeps a pass of the
    block's rows (each chunk copies the cloud's slice again). The L2 form
    only where not even a slice of four channels fits (N above
    ``BLOCK_SMEM // 16``). Measured on the H100 (tools/rowreduce_ablation.py,
    PERF.md): at 1024, 2048 and 4096 points the widest slice with 32 warps
    beat narrower slices, blocks of 8 warps, and more chunks than a wave."""
    fits = [L for L in AGG_LANES if N * 16 * L <= BLOCK_SMEM and (4 * L < C + 4 or L == 1)]
    if not fits:
        return AggPlan(0, 1)
    lanes = fits[0]
    per_sm = blocks_per_sm(N * 16 * lanes)
    warps = 32 if per_sm == 1 else 16
    slots = sms * min(per_sm, 32 // warps)
    rows_a_pass = warps * 32 // lanes
    blocks = B * -(-C // (4 * lanes))
    chunks = 1
    while blocks * chunks * 2 <= slots and -(-N // (2 * chunks)) >= rows_a_pass:
        chunks *= 2
    return AggPlan(lanes, chunks, warps)


def _plan_for(U: torch.Tensor, use_plan: Optional[AggPlan]) -> AggPlan:
    B, N, C = U.shape
    plan = use_plan or aggregate_plan(B, N, C, kernels.card_sms(U.device))
    if plan.lanes not in (0,) + AGG_LANES or not 1 <= plan.chunks <= N or (
            plan.lanes and (plan.smem(N) > BLOCK_SMEM or plan.warps not in AGG_WARPS)):
        raise NotImplementedError(f"the aggregate kernel takes no plan {plan} at N {N}")
    return plan


def supported(N: int, k: int) -> bool:
    """Shapes ``FusedEdgeConv`` sends to the fused kernel: the gate of
    ``pallas_edgeconv.supported`` without its row-tile test, since the CUDA
    kernel has no row tile. The kernels take every shape inside it."""
    return 2 <= k <= 64 and N <= 4096


def knn_aggregate_xla(U: torch.Tensor, idx: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Aggregates by gather + reduce, differentiable by autograd (``amax`` /
    ``amin`` split a tie's cotangent evenly, as ``jnp.max`` does).
    U (B, N, C), idx (B, N, k) -> M, m, S1, S2, each (B, N, C)."""
    g = _gather_neighbours(U, idx)
    return g.amax(2), g.amin(2), g.sum(2), (g * g).sum(2)


def _gather_neighbours(U: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, N, k = idx.shape
    C = U.shape[-1]
    flat = idx.reshape(B, N * k, 1).long().expand(-1, -1, C)
    return torch.gather(U, 1, flat).reshape(B, N, k, C)


def knn_select_plain(xf: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, Cf) -> idx (B, N, k) int32: the k smallest of
    (sq_i - 2 x_i.x_j) + sq_j per row, ascending, lower index first on ties.
    The inner product is summed in channel order, each product rounded."""
    return knn_plain(xf, xf, k)[1]


def aggregate_plain(U: torch.Tensor, idx: torch.Tensor):
    """(M, m, S1, S2, rM, rm) over the rows ``idx`` selects, in round order:
    rM / rm are the first rounds that attain the max / min."""
    g = _gather_neighbours(U, idx)
    k = idx.shape[-1]
    M = torch.full_like(g[:, :, 0], -_INF)
    m = torch.full_like(M, _INF)
    S1 = torch.zeros_like(M)
    S2 = torch.zeros_like(M)
    rM = torch.zeros(M.shape, dtype=torch.int32, device=U.device)
    rm = torch.zeros_like(rM)
    for r in range(k):
        sel = g[:, :, r]
        rM = torch.where(sel > M, r, rM)
        rm = torch.where(sel < m, r, rm)
        M = torch.maximum(M, sel)
        m = torch.minimum(m, sel)
        S1 = S1 + sel
        S2 = S2 + sel * sel
    return M, m, S1, S2, rM, rm


def _scatter_neighbours(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """w (B, N, k, C) summed onto the rows idx (B, N, k) names."""
    B, N, k, C = w.shape
    out = torch.zeros((B, N, C), dtype=w.dtype, device=w.device)
    flat = idx.reshape(B, N * k, 1).long().expand(-1, -1, C)
    return out.scatter_add_(1, flat, w.reshape(B, N * k, C))


def _bwd_sums(U, idx, t, gs1, gs2) -> torch.Tensor:
    """du[j] = (acc + s1) + (2 U[j]) s2, where acc, s1 and s2 sum t, gs1 and
    gs2 over the pairs (i, r) with idx[i, r] = j (on the CPU in ascending
    (i, r), the kernel's order)."""
    k = idx.shape[-1]
    acc = _scatter_neighbours(t, idx)
    s1 = _scatter_neighbours(gs1[:, :, None].expand(-1, -1, k, -1), idx)
    s2 = _scatter_neighbours(gs2[:, :, None].expand(-1, -1, k, -1), idx)
    return (acc + s1) + (2.0 * U) * s2


def bwd_first_plain(U, idx, rM, rm, gM, gm, gs1, gs2) -> torch.Tensor:
    rounds = torch.arange(idx.shape[-1], device=U.device)[None, None, :, None]
    zero = torch.zeros((), dtype=gM.dtype, device=U.device)
    t = (torch.where(rM[:, :, None] == rounds, gM[:, :, None], zero)
         + torch.where(rm[:, :, None] == rounds, gm[:, :, None], zero))
    return _bwd_sums(U, idx, t, gs1, gs2)


def bwd_split_plain(U, idx, M, m, gM, gm, gs1, gs2) -> torch.Tensor:
    g = _gather_neighbours(U, idx)
    isM = g == M[:, :, None]
    ism = g == m[:, :, None]
    wM = gM / isM.sum(2).clamp_min(1).to(gM.dtype)
    wm = gm / ism.sum(2).clamp_min(1).to(gm.dtype)
    zero = torch.zeros((), dtype=gM.dtype, device=U.device)
    t = (torch.where(isM, wM[:, :, None], zero) + torch.where(ism, wm[:, :, None], zero))
    return _bwd_sums(U, idx, t, gs1, gs2)


def _check(U: torch.Tensor, xf: torch.Tensor, k: int) -> None:
    B, N, _ = U.shape
    if xf.shape[:2] != (B, N) or not 1 <= k <= min(N, 64):
        raise ValueError(f"knn_aggregate: U {tuple(U.shape)}, xf {tuple(xf.shape)}, k {k}")


def _aligned(U: torch.Tensor) -> torch.Tensor:
    """U, contiguous and 16-byte aligned (the kernels read float4 rows)."""
    U = U.detach().contiguous()
    return U if U.data_ptr() % 16 == 0 else U.clone()


def knn_aggregate_fwd_kernel(U: torch.Tensor, xf: torch.Tensor, k: int,
                             track: bool, use_plan: Optional[AggPlan] = None):
    """Launch the forward kernels: (M, m, S1, S2, idx, rM, rm); rM / rm are
    uint8 (a round is below 64), and None without ``track``. The aggregate
    launches under ``aggregate_plan`` (or ``use_plan``)."""
    U = _aligned(U)
    xf = xf.detach().contiguous()
    kernels.require_cuda(U, xf)
    B, N, C = U.shape
    if U.dtype != torch.float32 or xf.dtype != torch.float32 or not supported(N, k):
        raise NotImplementedError(
            f"the knn_aggregate kernel is built for f32 clouds of N <= 4096 "
            f"points, got U {tuple(U.shape)} {U.dtype}, xf {xf.dtype}, k {k}")
    f = lambda dt: torch.empty((B, N, C), dtype=dt, device=U.device)
    M, m, S1, S2 = (f(torch.float32) for _ in range(4))
    rM, rm = (f(torch.uint8), f(torch.uint8)) if track else (None, None)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=U.device)
    sq = torch.empty((B, N), dtype=torch.float32, device=U.device)
    plan = _plan_for(U, use_plan)
    P, I = kernels.P, kernels.I
    kernels.launch("knn_aggregate_fwd", "edgeconv", "edgeconv_fwd",
                   (P, P, P) + (I,) * 9 + (P,) * 8,
                   xf.data_ptr(), U.data_ptr(), sq.data_ptr(), B, N, xf.shape[2], C,
                   k, int(track), *plan, M.data_ptr(), m.data_ptr(),
                   S1.data_ptr(),
                   S2.data_ptr(), idx.data_ptr(), kernels.ptr(rM), kernels.ptr(rm),
                   kernels.stream(U))
    return M, m, S1, S2, idx, rM, rm


def contributor_lists_plain(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' contributor lists: idx (B, N, k) -> (start
    (B, N + 1), entries (B, N k)) int32, where target j's list is
    ``entries[b, start[b, j]:start[b, j + 1]]``, the entries i k + r with
    idx[b, i, r] == j in ascending (i, r): a stable sort of each cloud's idx
    by target."""
    B, N, k = idx.shape
    flat = idx.reshape(B, N * k).long()
    entries = torch.sort(flat, dim=1, stable=True).indices.int()
    counts = torch.zeros((B, N), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    start = torch.zeros((B, N + 1), dtype=torch.long, device=idx.device)
    start[:, 1:] = torch.cumsum(counts, 1)
    return start.int(), entries


# csrc/edgeconv.cu: the backward's scratch (struct Lists): kMaxSegs = 16
# segments' counts, the list starts and the lists
_MAX_SEGS = 16


def _bwd_work(B: int, N: int, k: int, device) -> torch.Tensor:
    return torch.empty((B * (_MAX_SEGS * N + N + 1 + N * k),), dtype=torch.int32,
                       device=device)


def contributor_lists_kernel(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' counting sort alone (the library's
    ``edgeconv_contributor_lists`` check entry, off every model path and
    not counted): (start (B, N + 1), entries (B, N k)) as
    ``contributor_lists_plain`` gives them."""
    idx = idx.detach().to(torch.int32).contiguous()
    kernels.require_cuda(idx)
    B, N, k = idx.shape
    if not supported(N, k):
        raise NotImplementedError(f"contributor lists: idx {tuple(idx.shape)}")
    work = _bwd_work(B, N, k, idx.device)
    fn = kernels.library("edgeconv").edgeconv_contributor_lists
    fn.argtypes = [kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.P]
    err = fn(idx.data_ptr(), work.data_ptr(), B, N, k, kernels.stream(idx))
    if err != 0:
        raise RuntimeError(f"CUDA kernel edgeconv_contributor_lists failed to launch ({err})")
    o = B * _MAX_SEGS * N
    e = o + B * (N + 1)
    return work[o:e].view(B, N + 1), work[e:e + B * N * k].view(B, N * k)


def knn_aggregate_bwd_kernel(grad_mode: str, U, idx, a, c, gM, gm, gs1, gs2
                             ) -> torch.Tensor:
    """Launch a backward: the contributor lists by a counting sort of idx,
    then the ordered sums. ``first``: (a, c) = (rM, rm) as the forward
    kernel wrote them (uint8); ``split``: (a, c) = (M, m). Returns du
    (B, N, C) f32."""
    ts = [t.detach().contiguous() for t in (U, idx, a, c, gM, gm, gs1, gs2)]
    kernels.require_cuda(*ts)
    B, N, C = U.shape
    k = idx.shape[-1]
    want = torch.uint8 if grad_mode == "first" else torch.float32
    if (not supported(N, k) or any(t.dtype != torch.float32 for t in [ts[0]] + ts[4:])
            or ts[1].dtype != torch.int32 or ts[2].dtype != want or ts[3].dtype != want):
        raise NotImplementedError(
            f"the knn_aggregate backward kernels are built for f32 clouds of "
            f"N <= 4096 points, got U {tuple(U.shape)} {U.dtype}, k {k}")
    du = torch.empty((B, N, C), dtype=torch.float32, device=U.device)
    work = _bwd_work(B, N, k, U.device)
    P, I = kernels.P, kernels.I
    ptrs = [t.data_ptr() for t in ts]
    if grad_mode == "first":
        kernels.launch("knn_aggregate_bwd_first", "edgeconv", "edgeconv_bwd_first",
                       (P,) * 9 + (I,) * 4 + (P, P), *ptrs, work.data_ptr(), B, N, C, k,
                       du.data_ptr(), kernels.stream(U))
    else:
        wM, wm = torch.empty_like(du), torch.empty_like(du)
        kernels.launch("knn_aggregate_bwd_split", "edgeconv", "edgeconv_bwd_split",
                       (P,) * 11 + (I,) * 4 + (P, P), *ptrs, wM.data_ptr(),
                       wm.data_ptr(), work.data_ptr(), B, N, C, k, du.data_ptr(),
                       kernels.stream(U))
    return du


def aggregate_fwd_kernel(U: torch.Tensor, idx: torch.Tensor, track: bool,
                         use_plan: Optional[AggPlan] = None):
    """Launch the aggregate alone over a given idx (B, N, k): (M, m, S1, S2,
    rM, rm), rM / rm uint8 and None without ``track``; under
    ``aggregate_plan`` (or ``use_plan``)."""
    U = _aligned(U)
    idx = idx.detach().to(torch.int32).contiguous()
    kernels.require_cuda(U, idx)
    B, N, C = U.shape
    k = idx.shape[-1]
    if U.dtype != torch.float32 or idx.shape[:2] != (B, N) or not 1 <= k <= 64:
        raise NotImplementedError(f"aggregate_from_idx takes f32 U and k <= 64, got U "
                                  f"{tuple(U.shape)} {U.dtype}, idx {tuple(idx.shape)}")
    f = lambda dt: torch.empty((B, N, C), dtype=dt, device=U.device)
    M, m, S1, S2 = (f(torch.float32) for _ in range(4))
    rM, rm = (f(torch.uint8), f(torch.uint8)) if track else (None, None)
    plan = _plan_for(U, use_plan)
    P, I = kernels.P, kernels.I
    kernels.launch("aggregate_from_idx", "edgeconv", "edgeconv_aggregate",
                   (P, P) + (I,) * 8 + (P,) * 7, U.data_ptr(), idx.data_ptr(),
                   B, N, C, k, int(track), *plan, M.data_ptr(),
                   m.data_ptr(), S1.data_ptr(),
                   S2.data_ptr(), kernels.ptr(rM), kernels.ptr(rm), kernels.stream(U))
    return M, m, S1, S2, rM, rm


def _backward(ctx, gM, gm, gs1, gs2):
    """du of either Function, from the saved (U, idx, a, c)."""
    U, idx, a, c = ctx.saved_tensors
    if ctx.plain:
        fn = bwd_first_plain if ctx.grad_mode == "first" else bwd_split_plain
        return fn(U.float(), idx, a, c, gM, gm, gs1, gs2).to(U.dtype)
    return knn_aggregate_bwd_kernel(ctx.grad_mode, U, idx, a, c, gM, gm, gs1,
                                    gs2).to(U.dtype)


class _KnnAggregate(torch.autograd.Function):
    """``knn_aggregate`` with its custom backward; ``plain`` picks the plain
    PyTorch versions (CPU tensors) over the kernels (CUDA tensors)."""

    @staticmethod
    def forward(ctx, U, xf, k, grad_mode, plain):
        track = grad_mode == "first"
        if plain:
            idx = knn_select_plain(xf, k)
            M, m, S1, S2, rM, rm = aggregate_plain(U.float(), idx)
        else:
            M, m, S1, S2, idx, rM, rm = knn_aggregate_fwd_kernel(U, xf, k, track)
        ctx.save_for_backward(U, idx, *((rM, rm) if track else (M, m)))
        ctx.grad_mode, ctx.plain = grad_mode, plain
        ctx.mark_non_differentiable(idx)
        return M, m, S1, S2, idx

    @staticmethod
    def backward(ctx, gM, gm, gs1, gs2, _gidx):
        return _backward(ctx, gM, gm, gs1, gs2), None, None, None, None


class _AggregateFromIdx(torch.autograd.Function):
    """``aggregate_from_idx`` with the custom backward of ``knn_aggregate``
    (``pallas_edgeconv.py:322-337``)."""

    @staticmethod
    def forward(ctx, U, idx, grad_mode, plain):
        track = grad_mode == "first"
        idx = idx.to(torch.int32)
        if plain:
            M, m, S1, S2, rM, rm = aggregate_plain(U.float(), idx)
        else:
            M, m, S1, S2, rM, rm = aggregate_fwd_kernel(U, idx, track)
        ctx.save_for_backward(U, idx, *((rM, rm) if track else (M, m)))
        ctx.grad_mode, ctx.plain = grad_mode, plain
        return M, m, S1, S2

    @staticmethod
    def backward(ctx, gM, gm, gs1, gs2):
        return _backward(ctx, gM, gm, gs1, gs2), None, None, None


def _grad_mode(grad_mode: str) -> str:
    if grad_mode not in ("first", "split"):
        raise ValueError(f"grad_mode {grad_mode!r} (first or split)")
    return grad_mode


def knn_aggregate_plain(U: torch.Tensor, xf: torch.Tensor, k: int,
                        grad_mode: str = "split"):
    """The plain PyTorch version of ``knn_aggregate``, on any device."""
    _check(U, xf, k)
    return _KnnAggregate.apply(U, xf.detach(), k, _grad_mode(grad_mode), True)


def knn_aggregate(U: torch.Tensor, xf: torch.Tensor, k: int,
                  grad_mode: str = "split"):
    """U (B, N, C) f32, xf (B, N, Cf) f32 -> (M, m, S1, S2 (B, N, C) f32,
    idx (B, N, k) int32). The kernels on CUDA tensors, the plain versions
    on CPU ones."""
    _check(U, xf, k)
    return _KnnAggregate.apply(U, xf.detach(), k, _grad_mode(grad_mode),
                               U.device.type == "cpu")


def _check_idx(U: torch.Tensor, idx: torch.Tensor) -> None:
    if idx.shape[:2] != U.shape[:2] or not 1 <= idx.shape[-1] <= 64:
        raise ValueError(f"aggregate_from_idx: U {tuple(U.shape)}, idx {tuple(idx.shape)}")


def aggregate_from_idx_plain(U: torch.Tensor, idx: torch.Tensor,
                             grad_mode: str = "first"):
    """The plain PyTorch version of ``aggregate_from_idx``, on any device."""
    _check_idx(U, idx)
    return _AggregateFromIdx.apply(U, idx.detach(), _grad_mode(grad_mode), True)


def aggregate_from_idx(U: torch.Tensor, idx: torch.Tensor, grad_mode: str = "first"):
    """U (B, N, C) f32, idx (B, N, k) distance-ordered neighbours (each row
    distinct, as a kNN gives them) -> (M, m, S1, S2), each (B, N, C) f32;
    only U gets a gradient. The kernels on CUDA tensors, the plain versions
    on CPU ones."""
    _check_idx(U, idx)
    return _AggregateFromIdx.apply(U, idx.detach(), _grad_mode(grad_mode),
                                   U.device.type == "cpu")
