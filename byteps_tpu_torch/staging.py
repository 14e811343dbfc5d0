"""Host-to-device staging of the streamed PS tail.

The pulled sums land in host buffers that the exchange's pull threads
unpack into; the tail copies each leaf to the card as it completes. On the
card those buffers are PINNED (page-locked), so the copy is a true
asynchronous DMA issued with ``non_blocking=True`` on a side stream, and the
optimizer apply that consumes it waits on the copy's event on the device,
never on the host (``ChunkedApply``'s ``events``).

``PinnedPool`` recycles the buffers across rounds. A buffer goes back to the
pool with the event of the copy that reads it, and is handed out again only
once that event has completed: reusing it earlier would let the next round's
unpack overwrite gradients the card has not read yet.

On the CPU nothing is pinned or copied: the round's own host arrays become
the gradients.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .obs.metrics import observe_stage

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.float16): torch.float16}


class PinnedPool:
    """Host buffers by (elements, dtype), each reused only after the event
    it was released with has completed. ``pin``: page-lock them (the card's
    path); the tests pass False and events with a ``query()``."""

    def __init__(self, pin: bool = True) -> None:
        self.pin = pin
        self._lock = threading.Lock()
        self._free: Dict[Tuple[int, str], deque] = {}
        self.allocated = 0          # buffers made, for the tests and logs

    def alloc(self, n: int, dtype) -> np.ndarray:
        """A buffer of ``n`` elements: a free one whose copy completed, or
        a new one."""
        dtype = np.dtype(dtype)
        key = (int(n), dtype.str)
        with self._lock:
            free = self._free.get(key)
            if free:
                for i, (arr, ev) in enumerate(free):
                    if ev is None or ev.query():
                        del free[i]
                        return arr
            self.allocated += 1
        t = torch.empty(int(n), dtype=_TORCH_DTYPES[dtype],
                        pin_memory=self.pin)
        return t.numpy()

    def release(self, arr: np.ndarray, event) -> None:
        """Return ``arr`` once the copy recorded by ``event`` has read it
        (``event`` None: at once)."""
        key = (int(arr.size), arr.dtype.str)
        with self._lock:
            self._free.setdefault(key, deque()).append((arr, event))


class H2DStager:
    """The tail's host-to-device copies for gradients on ``device``:
    ``host_alloc`` makes the round's host leaves (pinned, from the pool, on
    the card; None on the CPU: the exchange's own ``np.empty``), ``copy``
    moves one summed leaf to the device, divided first on the host by the
    ``world`` worker processes whose sum it is (the JAX package's per-leaf
    divide, ``byteps_tpu/training.py:911-918``)."""

    def __init__(self, device, world: int = 1) -> None:
        self.device = torch.device(device)
        self.world = int(world)
        self.cuda = self.device.type == "cuda"
        self.pool = PinnedPool() if self.cuda else None
        self.stream = (torch.cuda.Stream(device=self.device) if self.cuda
                       else None)

    @property
    def host_alloc(self):
        return self.pool.alloc if self.pool is not None else None

    def copy(self, arr: np.ndarray, shape) -> Tuple[torch.Tensor,
                                                    Optional[object]]:
        """``arr`` (a flat summed leaf) as a tensor of ``shape`` on the
        device, and the event after its copy (None on the CPU). On the
        card the copy is asynchronous on the H2D stream, and ``arr`` goes
        back to the pool with its event."""
        t0 = time.time()
        if self.world > 1:
            # in place: the buffer is this round's own
            np.divide(arr, self.world, out=arr)
        src = torch.from_numpy(arr)
        if not self.cuda:
            out = src.view(shape)
            observe_stage("PS_H2D", time.time() - t0)
            return out, None
        with torch.cuda.stream(self.stream):
            dst = torch.empty(shape, dtype=src.dtype, device=self.device)
            dst.view(-1).copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.pool.release(arr, ev)
        observe_stage("PS_H2D", time.time() - t0)
        return dst, ev
