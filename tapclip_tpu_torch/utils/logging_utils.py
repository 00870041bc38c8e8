"""Logging, output tree, step timing and profiling.

Counterpart of ``tapclip_tpu/utils/logging_utils.py``: timestamped file +
stream logging in the reference's format, the
``results/{version}_{timestamp}/{models,plots,csv,logs}`` output tree,
:class:`StepTimer`, and :func:`maybe_profile`, a ``torch.profiler`` trace
(host and, on a card, device activity) written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from datetime import datetime
from typing import Dict, Iterator, Optional


def generate_output_paths(version: str, root: str = "results") -> Dict[str, str]:
    """The reference's output tree (``train.py:13-25``)."""
    now = datetime.now().strftime("%Y%m%d_%H%M%S")
    base_dir = os.path.join(root, f"{version}_{now}")
    paths = {
        "base": base_dir,
        "model_dir": os.path.join(base_dir, "models"),
        "plot_dir": os.path.join(base_dir, "plots"),
        "csv_dir": os.path.join(base_dir, "csv"),
        "log_dir": os.path.join(base_dir, "logs"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def setup_logging(log_file: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """File + stream logging with the reference's format (``train.py:43-51``)."""
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=level,
        datefmt="%H:%M:%S",
        handlers=handlers,
        force=True,
    )
    return logging.getLogger("tapclip_tpu_torch")


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


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block when a directory is given:
    host operators always, the card's kernels when CUDA is present; written
    as ``trace_dir/trace.json`` (Chrome trace format)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
