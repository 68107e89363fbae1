"""Tiled kNN of a query set in a database (port of
``point_dae_tpu/ops/pallas_knn.py:knn_pallas``).

``knn_kernel(query, database, k)`` returns, for each query row, the k
nearest database rows: ascending distances ``(qq - 2 q.y) + yy`` (not
clamped at zero) and their int32 indices, the lower index first on ties.
Neither input gets a gradient. On a CUDA tensor it is the ``knn_select``
entry of ``csrc/edgeconv.cu`` (the EdgeConv selection with the query set
apart from the database); on a CPU tensor its plain version ``knn_plain``,
which repeats the kernel's arithmetic (products rounded, summed in channel
order).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils import kernels

MAX_DB = 4096       # csrc/edgeconv.cu: kMaxStreamN
MAX_K = 64
CPU_BLOCK = 1 << 20   # distances a block of rows of knn_plain on the CPU


def _seq_sqnorm(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def _knn_rows(q, yt, qq, yy, k):
    dot = q[:, :, 0, None] * yt[:, 0, None, :]
    for c in range(1, q.shape[-1]):
        dot = dot + q[:, :, c, None] * yt[:, c, None, :]
    d = (qq[:, :, None] - 2.0 * dot) + yy[:, None, :]
    del dot
    srt = torch.sort(d, dim=-1, stable=True)
    return srt.values[..., :k].contiguous(), srt.indices[..., :k].int()


def knn_plain(query: torch.Tensor, database: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Nq, C), (B, Ndb, C) -> (dists (B, Nq, k) f32, idx (B, Nq, k)
    int32): the k smallest of (qq_i - 2 q_i.y_j) + yy_j per row, ascending,
    lower index first on ties. Each product is rounded and the inner
    product summed in channel order. On the CPU the rows go in blocks of
    about ``CPU_BLOCK`` distances, which stay in cache: the same elementwise
    operations, so the same bits, several times faster than one pass over
    the whole (B, Nq, Ndb) matrix a channel."""
    q, y = query.detach().float(), database.detach().float()
    qq, yy = _seq_sqnorm(q), _seq_sqnorm(y)
    yt = y.transpose(1, 2)                                   # (B, C, Ndb)
    if q.device.type != "cpu":
        return _knn_rows(q, yt, qq, yy, k)
    B, Nq = q.shape[:2]
    rows = max(1, CPU_BLOCK // y.shape[1])
    parts = [_knn_rows(q[b:b + 1, r:r + rows], yt[b:b + 1], qq[b:b + 1, r:r + rows],
                       yy[b:b + 1], k)
             for b in range(B) for r in range(0, Nq, rows)]
    return (torch.cat([p[0] for p in parts], 1).reshape(B, Nq, k),
            torch.cat([p[1] for p in parts], 1).reshape(B, Nq, k))


def knn_kernel(query: torch.Tensor, database: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kNN kernel on CUDA tensors, ``knn_plain`` on CPU ones. f32
    (B, Nq, C) and (B, Ndb <= 4096, C), k <= min(Ndb, 64)."""
    B, Nq, C = query.shape
    Ndb = database.shape[1]
    if database.shape[0] != B or database.shape[2] != C or not 1 <= k <= min(Ndb, MAX_K):
        raise ValueError(f"knn: query {tuple(query.shape)}, database "
                         f"{tuple(database.shape)}, k {k}")
    if query.device.type == "cpu":
        return knn_plain(query, database, k)
    q = query.detach().float().contiguous()
    y = database.detach().float().contiguous()
    kernels.require_cuda(q, y)
    if Ndb > MAX_DB:
        raise NotImplementedError(f"the knn kernel takes databases of up to {MAX_DB} "
                                  f"rows, got {Ndb}")
    dists = torch.empty((B, Nq, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, Nq, k), dtype=torch.int32, device=q.device)
    sqq = torch.empty((B, Nq), dtype=torch.float32, device=q.device)
    sqy = torch.empty((B, Ndb), dtype=torch.float32, device=q.device)
    P, I = kernels.P, kernels.I
    kernels.launch("knn", "edgeconv", "knn_select", (P, P, P, P, I, I, I, I, I, P, P, P),
                   q.data_ptr(), y.data_ptr(), sqq.data_ptr(), sqy.data_ptr(), B, Nq, Ndb,
                   C, k, dists.data_ptr(), idx.data_ptr(), kernels.stream(q))
    return dists, idx
