# -*- coding: utf-8 -*-
"""Named running averages of one or several series (counterpart of
``gaussiancity_tpu/utils/average_meter.py``; upstream
utils/average_meter.py:11-63)."""

from __future__ import annotations

from typing import Optional, Sequence, Union


class AverageMeter:
    """Without ``items``, one series whose ``val`` / ``avg`` / ``count``
    are scalars; with them, one series per item and lists."""

    def __init__(self, items: Optional[Sequence[str]] = None):
        self.items = list(items) if items is not None else None
        self.reset()

    def reset(self):
        n = 1 if self.items is None else len(self.items)
        self._val = [0.0] * n
        self._sum = [0.0] * n
        self._count = [0] * n

    def update(self, values: Union[float, Sequence[float]]):
        if not isinstance(values, (list, tuple)):
            values = [values]
        for i, v in enumerate(values):
            self._val[i] = float(v)
            self._sum[i] += float(v)
            self._count[i] += 1

    def val(self, idx: Optional[int] = None):
        if idx is None:
            return self._val if self.items else self._val[0]
        return self._val[idx]

    def count(self, idx: Optional[int] = None):
        if idx is None:
            return self._count if self.items else self._count[0]
        return self._count[idx]

    def avg(self, idx: Optional[int] = None):
        def _avg(i):
            return self._sum[i] / self._count[i] if self._count[i] else 0.0

        if idx is None:
            return ([_avg(i) for i in range(len(self._sum))]
                    if self.items else _avg(0))
        return _avg(idx)

    def as_dict(self):
        if self.items is None:
            raise ValueError("as_dict needs named items")
        return dict(zip(self.items, self.avg()))
