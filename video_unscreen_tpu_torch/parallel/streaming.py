"""Pinned, double-buffered chunk upload for the fused pipelines.

The counterpart of the JAX package's `parallel/streaming.py:FrameStreamer`
and `pipeline/fused_green.py:_prefetch_chunks`: one worker thread fills
chunk t+1 into one of two pinned host buffers (one call of the C++ host
prep, which releases the GIL) and copies it into one of two device
buffers on a dedicated copy stream, while the caller's stream computes on
chunk t. Four orderings keep the buffers from being reused too early:

- the caller's stream waits on the copy's event before the chunk's first
  step;
- a pinned buffer is refilled only after its copy's event has completed;
- a device buffer is overwritten only behind an event that the caller's
  stream recorded after the chunk's last step (the worker waits on the
  host until that event is recorded, then the copy stream waits on it);
- the caller records that event when it asks for the next chunk, so it
  must have enqueued every step of a chunk before it does.

An exception raised in the worker reaches the caller. With a CPU device
there is no pinning, no stream and no copy: the caller reads the host
buffer itself, which the worker refills only after the caller moved on.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

_SLOTS = 2


class ChunkStream:
    """Iterate `n_chunks` uint8 chunks of `shape` on `device`.

    `fill(i, out)` writes chunk i into the numpy array `out` (a host
    buffer of `shape`) and returns how many leading entries of it are
    valid; the iterator yields (device tensor of those entries, count)."""

    def __init__(self, fill: Callable[[int, np.ndarray], int],
                 n_chunks: int, shape: Tuple[int, ...],
                 device: torch.device):
        self.fill = fill
        self.n_chunks = int(n_chunks)
        self.shape = tuple(shape)
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, int]]:
        cuda = self.device.type == "cuda"
        host = [torch.empty(self.shape, dtype=torch.uint8, pin_memory=cuda)
                for _ in range(_SLOTS)]
        if cuda:
            dev = [torch.empty(self.shape, dtype=torch.uint8,
                               device=self.device) for _ in range(_SLOTS)]
            copy_stream = torch.cuda.Stream(self.device)
            copied = [torch.cuda.Event() for _ in range(_SLOTS)]
            done = [torch.cuda.Event() for _ in range(_SLOTS)]
        else:
            dev = host
        # a slot's device buffer is free once the caller is done with it
        free = [threading.Semaphore(1) for _ in range(_SLOTS)]
        ready: queue.Queue = queue.Queue()
        stop = threading.Event()

        def acquire(sem) -> bool:
            while not sem.acquire(timeout=0.1):
                if stop.is_set():
                    return False
            return True

        def worker():
            try:
                with torch.inference_mode():
                    for i in range(self.n_chunks):
                        k = i % _SLOTS
                        if cuda:
                            copied[k].synchronize()
                        elif not acquire(free[k]):
                            return
                        n_valid = self.fill(i, host[k].numpy())
                        if cuda:
                            if not acquire(free[k]):
                                return
                            with torch.cuda.stream(copy_stream):
                                copy_stream.wait_event(done[k])
                                dev[k].copy_(host[k], non_blocking=True)
                                copied[k].record(copy_stream)
                        ready.put((k, n_valid))
            except BaseException as e:  # the caller re-raises it
                ready.put(e)

        thread = threading.Thread(target=worker, daemon=True,
                                  name="chunk-stream")
        thread.start()
        try:
            for _ in range(self.n_chunks):
                item = ready.get()
                if isinstance(item, BaseException):
                    raise item
                k, n_valid = item
                if cuda:
                    torch.cuda.current_stream(self.device).wait_event(
                        copied[k])
                yield dev[k][:n_valid], n_valid
                if cuda:
                    done[k].record(torch.cuda.current_stream(self.device))
                free[k].release()
        finally:
            stop.set()
            thread.join()
