"""Multi-item running-average meters (the port's copy of
``point_dae_tpu/utils/meters.py``; role of the reference's utils/AverageMeter.py:2)."""
from __future__ import annotations

from typing import Sequence, Union


class AverageMeter:
    def __init__(self, items: Union[Sequence[str], int, None] = None):
        if items is None:
            names = ["value"]
        elif isinstance(items, int):
            names = [f"item{i}" for i in range(items)]
        else:
            names = list(items)
        self.names = names
        self.reset()

    def reset(self) -> None:
        self._sum = [0.0] * len(self.names)
        self._count = [0] * len(self.names)
        self._val = [0.0] * len(self.names)

    def update(self, values) -> None:
        if not isinstance(values, (list, tuple)):
            values = [values]
        for i, v in enumerate(values):
            self._val[i] = float(v)
            self._sum[i] += float(v)
            self._count[i] += 1

    def val(self, idx: int = 0) -> float:
        return self._val[idx]

    def avg(self, idx: int = None):
        if idx is None:
            return [s / max(c, 1) for s, c in zip(self._sum, self._count)]
        return self._sum[idx] / max(self._count[idx], 1)

    def count(self, idx: int = 0) -> int:
        return self._count[idx]
