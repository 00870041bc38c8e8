"""Step timing.

Counterpart of ``tapclip_tpu/utils/logging_utils.py``; only :class:`StepTimer`
is ported so far (the output tree, logging setup and profiler hooks are not).
"""

from __future__ import annotations

import time


class StepTimer:
    """Steady-state step timing -> items/sec.

    Host clock between :meth:`tic` and :meth:`toc`: a caller on the card
    makes the step end in a synchronisation (reading the loss does) before
    :meth:`toc`, or the time is that of the enqueue.
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times = []
        self._count = 0
        self._last = None

    def tic(self):
        self._last = time.perf_counter()

    def toc(self, items: int = 0):
        dt = time.perf_counter() - self._last
        self._count += 1
        if self._count > self.warmup:
            self._times.append((dt, items))
        return dt

    @property
    def mean_step_s(self) -> float:
        if not self._times:
            return float("nan")
        return sum(t for t, _ in self._times) / len(self._times)

    @property
    def items_per_sec(self) -> float:
        tot_t = sum(t for t, _ in self._times)
        tot_i = sum(i for _, i in self._times)
        return tot_i / tot_t if tot_t > 0 else float("nan")
