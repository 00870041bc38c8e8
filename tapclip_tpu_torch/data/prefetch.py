"""Host -> device pipelining: overlap decode and transfer with device compute.

Counterpart of ``tapclip_tpu/data/prefetch.py``:

* :func:`background_iter` runs the underlying iterator (decode, batching)
  on a producer thread with a bounded queue, so host JPEG decode overlaps
  device compute even when the loader itself is synchronous (the native C++
  batch decoder releases the GIL).
* :func:`device_prefetch` copies up to ``size`` batches ahead onto the
  device: each NumPy array of a batch is wrapped as a tensor, placed in
  pinned (page-locked) host memory when the device is a GPU, and copied
  with ``non_blocking=True``, so the copy runs while the current batch
  computes.  On the CPU the batch is wrapped and not copied.
* :func:`prefetch_to_device` composes the two.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


def background_iter(iterable: Iterable, depth: int = 2) -> Iterator:
    """Drain ``iterable`` on a daemon thread through a bounded queue.

    Exceptions on the producer re-raise at the consumer's next pull; the
    queue bound keeps at most ``depth`` decoded batches of host memory alive.
    A consumer that abandons the generator mid-epoch leaves the thread parked
    on the full queue until the process exits.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def produce():
        try:
            for item in iterable:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
            q.put(e)

    threading.Thread(target=produce, daemon=True, name="loader-prefetch").start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _put(x, device: torch.device):
    if isinstance(x, (tuple, list)):
        return type(x)(_put(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not torch.is_tensor(x):
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def device_prefetch(iterable: Iterable, size: int = 2, device=None) -> Iterator:
    """Copy batches onto ``device`` ``size`` batches ahead of the consumer.

    Each yielded element has the batch's structure (tuples, lists, dicts)
    with its arrays as tensors on ``device`` (default: the current CUDA
    device when there is one, else the CPU).
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    buf: collections.deque = collections.deque()
    for batch in iterable:
        buf.append(_put(batch, device))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def prefetch_to_device(iterable: Iterable, size: int = 2, device=None) -> Iterator:
    """Decode-ahead + asynchronous host-to-device copies in one wrapper."""
    return device_prefetch(background_iter(iterable, depth=size), size=size, device=device)
