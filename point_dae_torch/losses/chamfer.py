"""Chamfer distances (port of ``point_dae_tpu/losses/chamfer.py``).

``nn_distance(x, y) -> (dist1, dist2, idx1, idx2)`` is the load-bearing
contract. On CUDA tensors its forward runs the patch-chamfer kernel for
many tiny sets and the tiled kernel for large ones (both in
``csrc/chamfer.cu``, each one launch for both directions under its plan,
``patch_plan`` and ``tiled_plan``), and the matrix-expansion distances
otherwise; its backward is the gather-based recompute of
``chamfer.py:219-252``, with the scatter as a one-hot product for small
sets.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..ops.geometry import pairwise_sqdist
from ..parallel.mesh import get_mesh, global_sum
from ..utils import kernels


def _nn_half_xla(x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_j ||x_i - y_j||^2 and its first argmin over the expansion
    distances (the JAX package's XLA path)."""
    d = pairwise_sqdist(x, y)
    idx = torch.argmin(d, dim=-1)
    return d.gather(-1, idx[..., None])[..., 0], idx.int()


def use_small_kernel(x: torch.Tensor, m: int) -> bool:
    """``chamfer._use_small_pallas`` with "on TPU" read as "on CUDA"."""
    b, n, d = x.shape
    return x.device.type == "cuda" and d == 3 and n <= 64 and m <= 64 and b >= 4096


def use_tiled_kernel(x: torch.Tensor, m: int) -> bool:
    """``chamfer._use_pallas`` with "on TPU" read as "on CUDA"."""
    return x.device.type == "cuda" and x.shape[1] * m >= 512 * 512


def nn_half_small_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of the patch-chamfer kernel. x (P, N, 3),
    y (P, M, 3) -> (dist (P, N), idx (P, N) int32, near (P, N, 3)), with
    coordinate-wise distances and the first index on ties."""
    x = x.float()
    y = y.float()
    dif = [x[:, :, None, c] - y[:, None, :, c] for c in range(3)]
    d = (dif[0] * dif[0] + dif[1] * dif[1]) + dif[2] * dif[2]
    idx = torch.argmin(d, dim=-1)
    dist = d.gather(-1, idx[..., None])[..., 0]
    near = torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))
    return dist, idx.int(), near


H100_SMS = 132


def patch_stride(n: int) -> int:
    """Floats a patch of n points takes in the patch kernel's shared memory
    (``csrc/chamfer.cu:patch_stride``): 3 n rounded up to whole 16-byte
    words, made an odd number of words so that two patches start in
    different banks."""
    words = (3 * n + 3) // 4
    words += 1 - (words & 1)
    return 4 * words


PATCH_QUERIES = 3               # queries a thread scans together (csrc/chamfer.cu:kQueries)
PATCH_BLOCK = 256               # threads a block


class PatchPlan(NamedTuple):
    """How the patch kernel launches: ``patches`` patches a block of
    ``threads`` threads, which take the block's tasks (a task: up to
    PATCH_QUERIES queries of one patch and direction) in turn."""
    patches: int
    threads: int

    def smem(self, N: int, M: int) -> int:
        return self.patches * (patch_stride(N) + patch_stride(M)) * 4

    def blocks(self, P: int) -> int:
        return -(-P // self.patches)


def patch_groups(n: int) -> int:
    """Tasks a patch of n queries takes in one direction."""
    return -(-n // PATCH_QUERIES)


@lru_cache(maxsize=None)
def patch_plan(N: int, M: int) -> PatchPlan:
    """One round of tasks a block: PATCH_BLOCK threads take the tasks of
    PATCH_BLOCK // t patches (t tasks a patch, both directions). At the
    flagship's 13056 patches of 36 and 32 points (23 tasks a patch): 11
    patches a block, 1187 blocks. Measured on the H100
    (tools/chamfer_ablation.py, PERF.md): blocks of 64 or 128 threads, two
    rounds a block, and persistent blocks that copy their next group while
    they scan were no faster."""
    t = patch_groups(N) + patch_groups(M)
    return PatchPlan(max(1, PATCH_BLOCK // t), PATCH_BLOCK)


def patch_tasks(plan: PatchPlan, P: int, N: int, M: int) -> torch.Tensor:
    """The (patch, direction, query) triples (rows of an int64 tensor) that
    the tasks of the patch kernel under ``plan`` store, in the kernel's
    order: block b takes patches [b K, b K + K), its tasks the first
    direction's K ng_x first (patch f // ng, task g = f % ng), then the
    second's; a task g stores queries g, g + ng, ... below nq
    (ng = ``patch_groups(nq)``)."""
    gx, gy = patch_groups(N), patch_groups(M)
    K = plan.patches
    full = P // K                  # blocks of K patches; then one of P % K, if any
    out = []
    for b0, nb, kc in [(0, full, K)] + ([(full, 1, P % K)] if P % K else []):
        e = torch.arange(kc * (gx + gy))
        second = e >= kc * gx
        f = torch.where(second, e - kc * gx, e)
        ng = torch.where(second, gy, gx)
        nq = torch.where(second, M, N)
        q = (f % ng)[:, None] + ng[:, None] * torch.arange(PATCH_QUERIES)[None, :]
        keep = q < nq[:, None]
        one = torch.stack([(f // ng)[:, None].expand_as(q)[keep],
                           second[:, None].expand_as(q)[keep].long(), q[keep]], 1)
        p0 = (b0 + torch.arange(nb)) * K
        rows = one[None].repeat(nb, 1, 1)
        rows[..., 0] += p0[:, None]
        out.append(rows.reshape(-1, 3))
    return torch.cat(out)


def _outputs(device: torch.device, shape: Tuple[int, int], near: bool) -> list:
    """One direction's outputs: dist (f32), idx (int32) and, for the patch
    kernel, near (f32, 3 a point). Separate allocations cost the host less
    than views of one buffer."""
    outs = [torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device)]
    if near:
        outs.append(torch.empty(shape + (3,), dtype=torch.float32, device=device))
    return outs


def _small_launch(x: torch.Tensor, y: torch.Tensor, both: bool,
                  plan: Optional[PatchPlan] = None):
    x = x.detach().float().contiguous()
    y = y.detach().float().contiguous()
    kernels.require_cuda(x, y)
    P, N, _ = x.shape
    M = y.shape[1]
    if N > 64 or M > 64 or x.shape[2] != 3 or y.shape[2] != 3:
        raise ValueError(f"patch chamfer kernel takes sets of <= 64 3-D "
                         f"points, got {tuple(x.shape)} vs {tuple(y.shape)}")
    plan = plan or patch_plan(N, M)
    outs = _outputs(x.device, (P, N), True)
    if both:
        outs += _outputs(x.device, (P, M), True)
    ptrs = [t.data_ptr() for t in outs] + [0, 0, 0] * (not both)
    P_, I = kernels.P, kernels.I
    kernels.launch("nn_half_small", "chamfer", "nn_half_small_pair",
                   (P_, P_) + (I,) * 5 + (P_,) * 7, x.data_ptr(), y.data_ptr(), P, N, M,
                   plan.patches, plan.threads, *ptrs, kernels.stream(x))
    return tuple(outs)


def nn_half_small(x: torch.Tensor, y: torch.Tensor, plan: Optional[PatchPlan] = None):
    """The patch-chamfer kernel on CUDA tensors, its plain version on CPU
    ones. x (P, N<=64, 3), y (P, M<=64, 3) f32 -> (dist, idx, near) of x's
    points."""
    if x.device.type == "cpu":
        return nn_half_small_plain(x, y)
    return _small_launch(x, y, False, plan)


def nn_half_small_pair(x: torch.Tensor, y: torch.Tensor, plan: Optional[PatchPlan] = None):
    """Both directions of the patch chamfer, one launch on CUDA tensors (the
    two plain halves on CPU ones): (dist1, idx1, near1) of x's points in y,
    then (dist2, idx2, near2) of y's points in x."""
    if x.device.type == "cpu":
        return nn_half_small_plain(x, y) + nn_half_small_plain(y, x)
    return _small_launch(x, y, True, plan)


def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], each product rounded and the sum taken
    left to right (the order the tiled kernel keeps)."""
    out = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c] * b[..., c]
    return out


def nn_half_tiled_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of the tiled kernel. x (B, N, D), y (B, M, D)
    -> (dist (B, N) clamped at 0, idx (B, N) int32): the expansion distance
    (xx - 2 x.y) + yy in f32 and its first argmin."""
    x = x.float()
    y = y.float()
    xx = _seq_dot(x, x)
    yy = _seq_dot(y, y)
    xy = _seq_dot(x[:, :, None, :], y[:, None, :, :])
    d = (xx[:, :, None] - 2.0 * xy) + yy[:, None, :]
    idx = torch.argmin(d, dim=-1)
    return d.gather(-1, idx[..., None])[..., 0].clamp_min(0.0), idx.int()


class TiledPlan(NamedTuple):
    """How the tiled kernel launches: ``rows`` rows a thread, ``warps`` warps
    a block in ``groups`` column groups of whole warps, each scanning its
    own contiguous range of the targets, staged ``piece`` at a time."""
    rows: int
    warps: int
    groups: int
    piece: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    def block_rows(self) -> int:
        return self.threads // self.groups * self.rows

    def ranges(self, cols: int) -> List[Tuple[int, int]]:
        """Each group's column range [start, end) over ``cols`` targets."""
        span = -(-cols // self.groups)
        return [(min(g * span, cols), min((g + 1) * span, cols)) for g in range(self.groups)]

    def smem(self) -> int:
        stage = self.groups * self.piece * 16
        return max(stage, self.groups * self.block_rows() * 8 if self.groups > 1 else 0)

    def blocks(self, B: int, N: int, M: int) -> int:
        """Blocks of both directions."""
        br = self.block_rows()
        return B * (-(-N // br) + -(-M // br))

    def rows_of(self, n: int) -> torch.Tensor:
        """(blocks, block rows): the row each (block, thread, r) of a cloud's
        n rows holds in the kernel's mapping, thread t of a group holding
        rows row0 + t + r T / S (r < rows); every group scans the block's
        rows over its own range. Entries past n load row n - 1 and store
        nothing."""
        per = self.threads // self.groups
        slot = (torch.arange(per)[:, None] + per * torch.arange(self.rows)[None, :]).ravel()
        starts = torch.arange(-(-n // self.block_rows())) * self.block_rows()
        return starts[:, None] + slot[None, :]


TILED_ROWS = (1, 2, 4, 8)       # rows a thread the kernel is built for
TILED_CHUNK = 16                # columns a recorded chunk (csrc/chamfer.cu:kChunk)
TILED_WARPS = 8
TILED_STAGE = 2048              # targets a block stages at once (32 KB)
TILED_WARPS_AN_SM = 8           # warps an SM the plan asks for before it splits columns
TILED_MIN_SPAN = 128            # columns a group keeps at least, where it can


@lru_cache(maxsize=None)
def tiled_plan(B: int, N: int, M: int, sms: int = H100_SMS) -> TiledPlan:
    """Four rows a thread, blocks of eight warps; the columns split into
    the fewest groups (1, 2, 4 or 8) that give the card TILED_WARPS_AN_SM
    warps an SM over both directions, while a group keeps TILED_MIN_SPAN
    columns; a group stages at most TILED_STAGE / groups targets at once.
    At the DGCNN step's 128 x 1024 x 1024: one group, 256 blocks, 15.5
    warps an SM. Measured on the H100 (tools/chamfer_ablation.py, PERF.md):
    there, two and four groups (more warps, shorter scans, a merge) cost
    8% and 22% more, and blocks of four warps 2%."""
    rows, warps = 4, TILED_WARPS
    groups = 1
    while (groups < warps and
           TiledPlan(rows, warps, groups, 1).blocks(B, N, M) * warps < TILED_WARPS_AN_SM * sms
           and -(-min(N, M) // (2 * groups)) >= TILED_MIN_SPAN):
        groups *= 2
    piece = min(-(-max(N, M) // groups), TILED_STAGE // groups)
    return TiledPlan(rows, warps, groups, piece)


def _tiled_launch(x: torch.Tensor, y: torch.Tensor, both: bool,
                  plan: Optional[TiledPlan] = None):
    if x.shape[2] != 3 or y.shape[2] != 3:
        raise ValueError(f"tiled chamfer kernel is built for 3-D points, got "
                         f"{tuple(x.shape)} vs {tuple(y.shape)}")
    x = x.detach().float().contiguous()
    y = y.detach().float().contiguous()
    kernels.require_cuda(x, y)
    B, N, _ = x.shape
    M = y.shape[1]
    plan = plan or tiled_plan(B, N, M, kernels.card_sms(x.device))
    outs = _outputs(x.device, (B, N), False)
    if both:
        outs += _outputs(x.device, (B, M), False)
    ptrs = [t.data_ptr() for t in outs] + [0, 0] * (not both)
    P_, I = kernels.P, kernels.I
    kernels.launch("nn_half_tiled", "chamfer", "nn_half_tiled_pair",
                   (P_, P_) + (I,) * 7 + (P_,) * 5, x.data_ptr(), y.data_ptr(), B, N, M,
                   plan.rows, plan.warps, plan.groups, plan.piece, *ptrs, kernels.stream(x))
    return tuple(outs)


def nn_half_tiled(x: torch.Tensor, y: torch.Tensor, plan: Optional[TiledPlan] = None):
    """The tiled chamfer kernel on CUDA tensors, its plain version on CPU
    ones. x (B, N, 3), y (B, M, 3) f32, sets of any size -> (dist, idx) of
    x's points."""
    if x.device.type == "cpu":
        return nn_half_tiled_plain(x, y)
    return _tiled_launch(x, y, False, plan)


def nn_half_tiled_pair(x: torch.Tensor, y: torch.Tensor, plan: Optional[TiledPlan] = None):
    """Both directions of the tiled chamfer, one launch on CUDA tensors (the
    two plain halves on CPU ones): (dist1, idx1) of x's points in y, then
    (dist2, idx2) of y's points in x."""
    if x.device.type == "cpu":
        return nn_half_tiled_plain(x, y) + nn_half_tiled_plain(y, x)
    return _tiled_launch(x, y, True, plan)


def _nn_pair(x: torch.Tensor, y: torch.Tensor):
    """(dist1, idx1, near1-or-None, dist2, idx2, near2-or-None) of both
    directions. Both gates are symmetric in N and M, so both directions
    take the same route."""
    if use_small_kernel(x, y.shape[1]):
        return nn_half_small_pair(x, y)
    if use_tiled_kernel(x, y.shape[1]):
        d1, i1, d2, i2 = nn_half_tiled_pair(x, y)
    else:
        (d1, i1), (d2, i2) = _nn_half_xla(x, y), _nn_half_xla(y, x)
    return d1, i1, None, d2, i2, None


def _scatter(idx: torch.Tensor, vals: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, S) idx, (B, S, D) vals -> (B, out_len, D) sums."""
    if out_len <= 256 and idx.shape[1] <= 256:
        onehot = torch.nn.functional.one_hot(idx.long(), out_len).to(vals.dtype)
        return torch.einsum("bsl,bsd->bld", onehot, vals)
    out = torch.zeros((vals.shape[0], out_len, vals.shape[2]), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(1, idx.long()[..., None].expand_as(vals), vals)


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1, y_near, d2, i2, x_near = _nn_pair(xyz1, xyz2)
        if y_near is None:
            y_near = torch.gather(xyz2, 1, i1.long()[..., None].expand(-1, -1, xyz2.shape[2]))
            x_near = torch.gather(xyz1, 1, i2.long()[..., None].expand(-1, -1, xyz1.shape[2]))
        ctx.save_for_backward(xyz1, xyz2, i1, i2, y_near, x_near)
        ctx.mark_non_differentiable(i1, i2)
        return d1.clamp_min(0.0), d2.clamp_min(0.0), i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        xyz1, xyz2, i1, i2, y_near, x_near = ctx.saved_tensors
        gx_direct = g1[..., None] * (2.0 * (xyz1 - y_near))
        gy_direct = g2[..., None] * (2.0 * (xyz2 - x_near))
        gx = gx_direct + _scatter(i2, -gy_direct, xyz1.shape[1])
        gy = gy_direct + _scatter(i1, -gx_direct, xyz2.shape[1])
        return gx, gy


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, D), xyz2 (B, M, D) -> (dist1 (B, N), dist2 (B, M),
    idx1 (B, N), idx2 (B, M)), squared distances."""
    return _NNDistance.apply(xyz1, xyz2)


def chamfer_l2(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """mean(dist1) + mean(dist2) (ChamferDistanceL2)."""
    d1, d2, _, _ = nn_distance(xyz1, xyz2)
    return d1.mean() + d2.mean()


def chamfer_l1(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """(mean(sqrt(dist1 + eps)) + mean(sqrt(dist2 + eps))) / 2, eps 1e-12
    (ChamferDistanceL1; the eps keeps the gradient finite at exact
    matches)."""
    d1, d2, _, _ = nn_distance(xyz1, xyz2)
    return ((d1 + 1e-12).sqrt().mean() + (d2 + 1e-12).sqrt().mean()) / 2.0


def chamfer_l2_coarse2fine(xyz1: torch.Tensor, xyz2: torch.Tensor, fine1: torch.Tensor,
                           fine2: torch.Tensor):
    """The centre chamfer-L2 of xyz1 and xyz2 (B, G, 3), then the patch
    chamfer-L2 between each patch of one side (fine (B, G, S, 3)) and the
    other side's patch at its nearest centre, both ways
    (ChamferDistanceL2_corase2fine): (centre term, fine term). The centres'
    call is small and plain; the two patch calls, over B * G pairs, take the
    patch kernel where B * G >= 4096."""
    d1, d2, i1, i2 = nn_distance(xyz1, xyz2)
    B, G, S, _ = fine1.shape
    t1 = take_points(fine2.reshape(B, G, S * 3), i1).reshape(B * G, S, 3)
    t2 = take_points(fine1.reshape(B, G, S * 3), i2).reshape(B * G, S, 3)
    fd1 = chamfer_l2(fine1.reshape(B * G, S, 3), t1)
    fd2 = chamfer_l2(fine2.reshape(B * G, S, 3), t2)
    return d1.mean() + d2.mean(), fd1 + fd2


def weighted_mean(per: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum(w * per) / max(sum(w), 1e-8); under a process group both sums
    run over the global batch (``global_ratio``)."""
    return global_ratio((per * weight).sum(), weight.sum())


def global_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / max(den, 1e-8) for two sums over a batch; under a process
    group both are summed over ranks first (one differentiable all-reduce),
    so every rank holds the global batch's ratio."""
    if get_mesh().world > 1:
        num, den = global_sum(torch.stack([num, den.to(num.dtype)]))
    return num / den.clamp_min(1e-8)


def masked_chamfer_l2(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Per-set chamfer-L2 over the leading axis, weighted: sum(w * per) /
    max(sum(w), 1e-8). xyz1/xyz2 (B, S, D), weight (B,)."""
    d1, d2, _, _ = nn_distance(xyz1, xyz2)
    return weighted_mean(d1.mean(-1) + d2.mean(-1), weight)


def masked_chamfer_l1(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """``masked_chamfer_l2`` with each set's chamfer-L1 as the term."""
    d1, d2, _, _ = nn_distance(xyz1, xyz2)
    per = ((d1 + 1e-12).sqrt().mean(-1) + (d2 + 1e-12).sqrt().mean(-1)) / 2.0
    return weighted_mean(per, weight)


# ------- normal-aware distances (the MaskSurf family)

def normalize(v: torch.Tensor) -> torch.Tensor:
    """v over its norm along the last axis (at least 1e-12)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def dis_normalized_l2(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """Orientation-agnostic distance of unit normals: min(|n1 - n2|^2,
    |n1 + n2|^2) over the last axis."""
    n1, n2 = normalize(n1), normalize(n2)
    return torch.minimum(((n1 - n2) ** 2).sum(-1), ((n1 + n2) ** 2).sum(-1))


def dis_normalized_l1(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    n1, n2 = normalize(n1), normalize(n2)
    return torch.minimum((n1 - n2).abs().sum(-1), (n1 + n2).abs().sum(-1))


def dis_normalized_l2_strict(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    n1, n2 = normalize(n1), normalize(n2)
    return ((n1 - n2) ** 2).sum(-1)


def take_points(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (P, N) or (P, N, C), idx (P, M) -> a's rows at idx along axis 1."""
    if a.dim() == 2:
        return torch.gather(a, 1, idx.long())
    return torch.gather(a, 1, idx.long()[..., None].expand(-1, -1, a.shape[-1]))


def masked_chamfer_withnormal_idx(xyz1, xyz2, normal1, normal2, weight, normal_dis=None):
    """``masked_chamfer_l2_withnormal`` and the chamfer's indices (i1, i2),
    for callers that pair further channels through the same
    correspondence."""
    normal_dis = normal_dis or dis_normalized_l2
    d1, d2, i1, i2 = nn_distance(xyz1, xyz2)
    nd1 = normal_dis(normal1, take_points(normal2, i1))
    nd2 = normal_dis(normal2, take_points(normal1, i2))
    return (weighted_mean(d1.mean(-1) + d2.mean(-1), weight),
            weighted_mean(nd1.mean(-1) + nd2.mean(-1), weight), i1, i2)


def masked_chamfer_l2_withnormal(xyz1, xyz2, normal1, normal2, weight, normal_dis=None):
    """Per-set chamfer-L2 and normal distance through the xyz
    correspondence (ChamferDistanceL2_withnormal), weighted over the
    leading axis: (xyz loss, normal loss). xyz and normals (P, S, 3),
    weight (P,); ``normal_dis`` defaults to ``dis_normalized_l2``."""
    return masked_chamfer_withnormal_idx(xyz1, xyz2, normal1, normal2, weight,
                                         normal_dis)[:2]


LOSS_REGISTRY = {"cdl1": chamfer_l1, "cdl2": chamfer_l2}


def build_loss_func(loss_type: str):
    """The model-side loss switch (cdl1, cdl2)."""
    if loss_type not in LOSS_REGISTRY:
        raise NotImplementedError(f"loss {loss_type!r} (supported: cdl1, cdl2)")
    return LOSS_REGISTRY[loss_type]
