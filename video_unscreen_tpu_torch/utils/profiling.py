"""Tracing and per-stage timing.

Port of `video_unscreen_tpu/utils/profiling.py`: `StageTimer` keeps the
reference's per-stage wall-clock report; `trace` writes a `torch.profiler`
Chrome trace (host and, on a card, CUDA activity), and `maybe_trace` does
so when $VU_TRACE_DIR is set. XLA's `compiled_stats` has no counterpart
here (ROADMAP.md item 11: the meta-device operation count).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimer:
    """Per-stage wall-clock accumulator (the reference's `runtime` dict).

    With `block=True` each stage ends with `torch.cuda.synchronize()`, so
    a stage's time includes the device work it enqueued; otherwise it is
    the host's time to enqueue it."""

    def __init__(self, block: bool = False):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.block = block

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.block and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.times[name] += time.perf_counter() - start
            self.counts[name] += 1

    def add(self, name: str, seconds: float):
        self.times[name] += seconds
        self.counts[name] += 1

    def report(self, numframes: Optional[int] = None) -> str:
        """The reference's report: seconds a frame of each stage."""
        lines = ["-" * 10 + "runtime" + "-" * 10]
        denom = numframes or 1
        for key, value in self.times.items():
            lines.append(f"{key:>16s}: {value / denom:.3f}s")
        lines.append("-" * 10 + "-------" + "-" * 10)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` over a region; writes `trace.json` (Chrome trace
    format, readable by Perfetto) into `log_dir`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def maybe_trace():
    """Trace iff $VU_TRACE_DIR is set."""
    log_dir = os.environ.get("VU_TRACE_DIR")
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield
