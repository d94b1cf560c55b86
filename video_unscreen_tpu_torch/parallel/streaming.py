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

`FrameStreamer` is the JAX class of that name on this stream: chunks of a
clip's frames (arrays, or files read with the port's own readers) on the
device, each chunk a tensor of its own.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.fileio import parallel_read_img

_SLOTS = 2


class ChunkStream:
    """Iterate `n_chunks` chunks of `shape` and `dtype` (uint8 by default)
    on `device`, through `slots` buffers (two by default).

    `fill(i, out)` writes chunk i into the numpy array `out` (a host
    buffer of `shape`) and returns how many leading entries of it are
    valid; the iterator yields (device tensor of those entries, count)."""

    def __init__(self, fill: Callable[[int, np.ndarray], int],
                 n_chunks: int, shape: Tuple[int, ...],
                 device: torch.device, dtype: torch.dtype = torch.uint8,
                 slots: int = _SLOTS):
        self.fill = fill
        self.n_chunks = int(n_chunks)
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self.dtype = dtype
        self.slots = max(int(slots), 1)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, int]]:
        cuda = self.device.type == "cuda"
        n_slots = self.slots
        host = [torch.empty(self.shape, dtype=self.dtype, pin_memory=cuda)
                for _ in range(n_slots)]
        if cuda:
            dev = [torch.empty(self.shape, dtype=self.dtype,
                               device=self.device) for _ in range(n_slots)]
            copy_stream = torch.cuda.Stream(self.device)
            copied = [torch.cuda.Event() for _ in range(n_slots)]
            done = [torch.cuda.Event() for _ in range(n_slots)]
        else:
            dev = host
        # a slot's device buffer is free once the caller is done with it
        free = [threading.Semaphore(1) for _ in range(n_slots)]
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
                        k = i % n_slots
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


class FrameStreamer:
    """Iterate a clip in device-resident chunks, as the JAX package's
    `FrameStreamer`, with its constructor.

    `paths_or_frames`: file paths (read with the port's own readers,
    `utils/fileio.py:parallel_read_img`; a JPEG needs libjpeg, which the
    card's machine lacks) or uint8 (H, W, 3) arrays. `chunk_size` frames
    a chunk, the last one shorter. `preprocess`: a host transform of each
    stacked (n, H, W, 3) chunk that keeps the leading n and gives every
    chunk one shape and dtype past it. `device`: where the chunks land;
    None is the card (without one this raises, as the port's entry points
    do). `prefetch`: the chunks staged ahead of the caller, the buffers
    of the `ChunkStream` underneath (two by default, as JAX's queue
    depth). Each chunk is yielded as a tensor of its own (a copy out of
    the stream's buffer), so a caller may keep it."""

    def __init__(self, paths_or_frames: Sequence, chunk_size: int = 8,
                 preprocess: Optional[Callable] = None, device=None,
                 prefetch: int = 2):
        self.items = list(paths_or_frames)
        self.chunk_size = int(chunk_size)
        self.preprocess = preprocess
        self.device = resolve_device("cuda" if device is None else device)
        self.prefetch = int(prefetch)

    @staticmethod
    def _load(item) -> np.ndarray:
        if isinstance(item, (str, bytes)):
            path = item.decode() if isinstance(item, bytes) else item
            return parallel_read_img([path], num_workers=1)[0]
        return np.asarray(item)

    def _host_chunk(self, items) -> np.ndarray:
        arr = np.stack([self._load(it) for it in items])
        if self.preprocess is not None:
            arr = np.asarray(self.preprocess(arr))
        if arr.shape[0] != len(items):
            raise ValueError(f"preprocess turned {len(items)} frames into "
                             f"{arr.shape[0]}")
        return arr

    def __iter__(self) -> Iterator[torch.Tensor]:
        size = self.chunk_size
        chunks = [self.items[i:i + size]
                  for i in range(0, len(self.items), size)]
        if not chunks:
            return
        first = [self._host_chunk(chunks[0])]
        head = first[0]

        def fill(i: int, out: np.ndarray) -> int:
            arr = first.pop() if i == 0 else self._host_chunk(chunks[i])
            if arr.shape[1:] != out.shape[1:] or arr.dtype != out.dtype:
                raise ValueError(
                    f"chunk {i} is {arr.dtype} {arr.shape[1:]}, chunk 0 "
                    f"was {out.dtype} {out.shape[1:]}")
            out[:len(arr)] = arr
            return len(arr)

        stream = ChunkStream(fill, len(chunks), (size,) + head.shape[1:],
                             self.device,
                             dtype=torch.from_numpy(head[:0]).dtype,
                             slots=self.prefetch)
        del head
        for chunk, _ in stream:
            yield chunk.clone()
