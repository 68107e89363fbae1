"""Host-side batching dataloader with background prefetch (the port's copy
of ``point_dae_tpu/data/loader.py``).

Role of the reference's torch DataLoader and sampler, much thinner because
augmentation and corruption run on the device: the loader only shuffles
indices, stacks numpy arrays and prefetches a couple of batches on a worker
thread. The epoch's order is the JAX loader's (numpy ``default_rng(seed *
9973 + epoch)``), so both packages see the same batches. Under a process
group (``num_hosts`` ranks, ``parallel/mesh.py:loader_shard_kwargs``) rank
``host_id`` takes a contiguous slice of every global batch, so the global
batch is bitwise the one-process batch, and ``drop_last=False`` pads the
tail global batch by wrapping, like torch's DistributedSampler.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


def _collate(samples) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v0 in samples[0].items():
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        elif isinstance(v0, (int, np.integer)):
            out[k] = np.asarray([s[k] for s in samples], np.int32)
        else:
            out[k] = np.asarray([s[k] for s in samples])
    return out


class DataLoader:
    PREFETCH = 2           # batches the worker thread may read ahead

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size          # this rank's rows of a batch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (DistributedSampler.set_epoch role)."""
        self.epoch = epoch

    def __len__(self):
        """Batches an epoch: global batches of ``batch_size * num_hosts``,
        the same count on every rank."""
        n, gb = len(self.dataset), self.batch_size * self.num_hosts
        if self.drop_last:
            return n // gb
        return (n + gb - 1) // gb

    def _indices(self) -> np.ndarray:
        """This rank's index stream: rank h owns rows [h * B, (h + 1) * B)
        of each global batch; without ``drop_last`` the tail global batch
        is padded by wrapping, so every rank has a full batch at every
        step."""
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng(self.seed * 9973 + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.num_hosts == 1:
            return idx
        gb = self.batch_size * self.num_hosts
        nb = len(self)
        pad = nb * gb - len(idx)
        if pad > 0 and len(idx) > 0:
            reps = (pad + len(idx) - 1) // len(idx)
            idx = np.concatenate([idx, np.tile(idx, reps)[:pad]])
        out = [idx[g * gb + self.host_id * self.batch_size:
                   g * gb + (self.host_id + 1) * self.batch_size] for g in range(nb)]
        return np.concatenate(out) if out else idx[:0]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        # datasets exposing load_batch (ShapeNet's native threaded .npy
        # reader) take the whole index slice at once
        fast = getattr(self.dataset, "load_batch", None)

        def put(item) -> bool:
            """Bounded put that keeps checking the stop flag, so a consumer
            abandoning the iterator mid-epoch never leaves the worker (and
            its prefetched batch) blocked on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    if fast is not None:
                        batch = fast([int(i) for i in sel])
                    else:
                        batch = _collate([self.dataset[int(i)] for i in sel])
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
                # without this a read error kills the thread before the end
                # sentinel and the consumer blocks in q.get() forever
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=5.0)
