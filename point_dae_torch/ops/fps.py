"""Furthest point sampling: kernel wrapper, gate and plain version.

Port of ``point_dae_tpu/ops/pallas_fps.py`` (``fps_pallas_batched`` and
``fps_pallas``, one function in two TPU layouts); the CUDA kernel is
``csrc/fps.cu`` over the loop of ``csrc/fps_loop.cuh``, which the fused
patchify's FPS phase shares, and ``plan`` says how a launch spreads the
clouds over the card. Conventions: the first pick is index 0, points with
``(x*x + y*y) + z*z <= 1e-3`` are never picked, each pick is the argmax of
the running min-distance over the selectable points (the others count as
-1), lowest index first on ties. Distances are computed coordinate-wise,
``(dx*dx + dy*dy) + dz*dz``, in that order and without fused multiply-adds,
in both versions, so their picks agree bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import kernels

BLOCK_THREADS = 256      # csrc/fps_loop.cuh kThreads: most threads a block
PPTS = (4, 8, 16, 32)    # points a thread in registers (the kernel's instantiations)
BLOCK_POINTS = BLOCK_THREADS * PPTS[-1]          # 8192 points a block
CLUSTERS = (1, 2, 4, 8)  # blocks a cloud: 1, or a thread-block cluster
REGISTER_POINTS = CLUSTERS[-1] * BLOCK_POINTS    # 65536; above, the streamed form
STREAM_THREADS = BLOCK_THREADS                   # the streamed form's one block a cloud
# Measured on the H100 (tools/fps_ablation.py): a block of four warps with
# more points a thread beats eight warps with fewer; a cloud gains from a
# cluster only while each block keeps 2048 points or more (the cluster's
# exchange costs about 0.2 us an iteration), and from a cluster of eight
# blocks not at all (it sends each candidate to eight blocks and waits for
# eight): eight only where the registers need them.
TARGET_THREADS = 128
MIN_SHARE = 2048
MAX_SPREAD = 4
H100_SMS = 132


class FpsPlan(NamedTuple):
    """How ``csrc/fps.cu`` (and the patchify's FPS phase) launches: ``cluster``
    blocks a cloud of ``threads`` threads with ``ppt`` points a thread in
    registers, or with ``ppt`` 0 the streamed form."""
    cluster: int
    threads: int
    ppt: int

    @property
    def form(self) -> str:
        return "stream" if self.ppt == 0 else "cluster" if self.cluster > 1 else "block"


def block_shape(share: int) -> Tuple[int, int]:
    """(threads, points a thread) of a block holding ``share`` points: the
    fewest points a thread that keep it within ``TARGET_THREADS`` threads
    (at 32 points a thread, up to ``BLOCK_THREADS``)."""
    ppt = next(p for p in PPTS if p * TARGET_THREADS >= share or p == PPTS[-1])
    return -(-share // (32 * ppt)) * 32, ppt


def plan(batch: int, n_points: int, sms: int = H100_SMS,
         cluster_slots: Optional[Callable[[int, int, int], int]] = None) -> FpsPlan:
    """The launch for ``batch`` clouds of ``n_points``: the fewest blocks a
    cloud whose registers hold it (at most ``BLOCK_POINTS`` a block), then
    twice as many, up to ``MAX_SPREAD``, while each block keeps ``MIN_SHARE``
    points or more and the card holds every cloud's cluster at once (``cluster_slots(c,
    threads, ppt)`` clusters, as the card reports them for that launch; by
    default ``sms // c``); each block as ``block_shape`` says. Above
    ``REGISTER_POINTS``, the streamed form."""
    if n_points > REGISTER_POINTS:
        return FpsPlan(1, STREAM_THREADS, 0)

    def shape(c: int) -> FpsPlan:
        return FpsPlan(c, *block_shape(-(-n_points // c)))

    def fits(p: FpsPlan) -> bool:
        return batch <= (cluster_slots(*p) if cluster_slots else sms // p.cluster)

    c = CLUSTERS[0]
    while c * BLOCK_POINTS < n_points:
        c *= 2
    while c < MAX_SPREAD and n_points >= 2 * c * MIN_SHARE and fits(shape(2 * c)):
        c *= 2
    return shape(c)


_cards: Dict[int, Tuple[int, Callable[[int, int, int], int]]] = {}


def card(device: torch.device) -> Tuple[int, Callable[[int, int, int], int]]:
    """(SMs, cluster_slots) of a CUDA device, for ``plan``: cluster_slots(c,
    threads, ppt) is the number of clusters of that launch the card holds at
    once (``cudaOccupancyMaxActiveClusters``, asked once a launch shape)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _cards:
        fn = kernels.library("fps").fps_cluster_slots
        fn.argtypes = [kernels.I] * 3
        fn.restype = kernels.I
        known: Dict[Tuple[int, int, int], int] = {}

        def slots(c: int, threads: int, ppt: int) -> int:
            key = (c, threads, ppt)
            if key not in known:
                with torch.cuda.device(index):
                    known[key] = fn(c, threads, ppt)
                if known[key] < 1:
                    raise RuntimeError(f"the card holds no cluster of the fps kernel {key}")
            return known[key]

        _cards[index] = (torch.cuda.get_device_properties(index).multi_processor_count, slots)
    return _cards[index]


def use_fps_kernel(device_type: str, n_points: int) -> bool:
    """The union of the two FPS gates of ``geometry.py:115-126`` (the
    batched kernel at N >= 512, N % 128 == 0; the per-row one at N >= 512,
    N % 8 == 0) with "on TPU" read as "on CUDA". No upper bound: the
    kernel takes every N."""
    return device_type == "cuda" and n_points >= 512 and n_points % 8 == 0


def kernel_takes(n_points: int, n_samples: int) -> bool:
    """The shapes ``csrc/fps.cu`` takes: any cloud size, registers up to
    ``REGISTER_POINTS`` points (across a cluster of blocks above
    ``BLOCK_POINTS``) and the streamed form above."""
    return n_points >= 1 and n_samples >= 1


def furthest_point_sample_plain(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3) -> (B, n_samples)
    int32, on whatever device ``points`` lies."""
    points = points.detach().float()
    B, N, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    selectable = (x * x + y * y) + z * z > 1e-3
    min_d = torch.full((B, N), 1e10, dtype=torch.float32, device=points.device)
    neg = torch.full((), -1.0, device=points.device)
    out = torch.empty((B, n_samples), dtype=torch.long, device=points.device)
    last = torch.zeros(B, dtype=torch.long, device=points.device)
    for i in range(n_samples):
        out[:, i] = last
        p = points.gather(1, last[:, None, None].expand(B, 1, 3))
        dx, dy, dz = x - p[..., 0], y - p[..., 1], z - p[..., 2]
        min_d = torch.minimum(min_d, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(torch.where(selectable, min_d, neg), dim=1)
    return out.int()


def fps_kernel(points: torch.Tensor, n_samples: int,
               use_plan: Optional[FpsPlan] = None) -> torch.Tensor:
    """Launch the kernel. points: (B, N, 3) f32 contiguous on a CUDA device.
    Returns (B, n_samples) int32. ``use_plan`` replaces ``plan``'s launch (a
    check or an ablation reaching every form)."""
    kernels.require_cuda(points)
    B, N, D = points.shape
    if points.dtype != torch.float32 or D != 3 or not kernel_takes(N, n_samples):
        raise ValueError(f"fps kernel is built for (B, N, 3) f32 and n_samples >= 1, got "
                         f"{tuple(points.shape)} {points.dtype}, {n_samples}")
    p = use_plan or plan(B, N, *card(points.device))
    out = torch.empty((B, n_samples), dtype=torch.int32, device=points.device)
    # the streamed form's (x, y, z, min_d) a point
    buf = (torch.empty((B, N, 4), dtype=torch.float32, device=points.device)
           if p.ppt == 0 else None)
    P, I = kernels.P, kernels.I
    kernels.launch("fps", "fps", "fps", (P, I, I, I, I, I, I, P, P, P), points.data_ptr(), B,
                   N, n_samples, p.cluster, p.threads, p.ppt, kernels.ptr(buf),
                   out.data_ptr(), kernels.stream(points))
    return out


def furthest_point_sample(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, N, 3) -> (B, n_samples) int32: the kernel on a CUDA tensor inside
    the gate, the plain version on a CPU tensor or outside the gate."""
    B, N, _ = points.shape
    if not use_fps_kernel(points.device.type, N):
        return furthest_point_sample_plain(points, n_samples)
    return fps_kernel(points.detach().float().contiguous(), n_samples)
