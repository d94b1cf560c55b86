"""Run one function on N ranks of a `torch.distributed` job.

`run_ranks(fn, n, args)` spawns n processes with the `spawn` start method
(`fork` breaks once CUDA is initialised in the parent), joins them in one
process group through a `file://` store in a fresh temporary directory
(no TCP port, so several jobs can run side by side), calls
`fn(rank, *args)` on each and returns the ranks' results in rank order.

- `fn` must be a module-level function of a module that imports no JAX:
  the child unpickles it by its module path and imports that module.
- Every rank runs `torch.set_num_threads(threads)`.
- The process group gets `collective_timeout`. Each rank reports once
  every rank has joined the group (a barrier after the join, so no rank
  runs `fn`, or leaves, while a peer is still connecting); the parent
  waits at most START_TIMEOUT seconds for every rank to join (the spawn,
  the imports and the rendezvous, which take seconds on an idle host and
  several times that on a loaded one), then for the results at most
  `timeout` seconds after the last join or progress report (`heartbeat`,
  which a long `fn` calls between its phases). Past either deadline it
  kills every rank still alive and raises. A rank that raises sends its
  traceback and the parent raises at once; a rank that dies without a
  result (a crash, a kill) raises too. So a hung collective fails
  `timeout` seconds after the ranks are up, however long they took to
  start.
- `backend="nccl"` puts rank r on card r % the card count; with `gloo`,
  `fn` places its own tensors (ranks may share one card).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

_JOINED = "joined"  # a rank's first message: it is in the process group
_ALIVE = "alive"  # a rank's progress report (`heartbeat`)
START_TIMEOUT = 300.0  # seconds for every rank to start and join
_report = None  # in a rank: (the results queue, the rank), for `heartbeat`


def heartbeat() -> None:
    """Report progress from a rank of `run_ranks`: the parent's `timeout`
    runs again from now, so a long job whose phases each end in a report
    gives each phase the whole `timeout`, however loaded the host. Does
    nothing outside a rank."""
    if _report is not None:
        results, rank = _report
        results.put((rank, _ALIVE, None))


def _rank_main(fn: Callable, rank: int, n_ranks: int, store: str,
               backend: str, collective_timeout: float, threads: int,
               args: Sequence, results) -> None:
    """One rank: join the group, report it, run `fn`, report its result or
    its traceback (before leaving the group, which can take a while), then
    leave."""
    global _report
    joined = False
    try:
        torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=n_ranks,
            rank=rank, timeout=timedelta(seconds=collective_timeout))
        joined = True
        # gloo returns from init once this rank's own connections are up;
        # a rank that then ran `fn`, returned and left could close its
        # pairs under a peer still connecting ("Connection closed by
        # peer"). Nobody starts before everybody is in.
        dist.barrier()
        results.put((rank, _JOINED, None))
        _report = (results, rank)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if joined:
            dist.destroy_process_group()


def _failure(procs, done, results, errors, grace: float = 2.0):
    """The error of a failed run: every rank that died without a result
    and every traceback that arrives within `grace` seconds (one failure
    makes its peers fail too; the first to report need not be the
    cause). A result that arrives meanwhile counts: a rank that sent it
    and then exited non-zero did not die before its result. None when
    nothing failed after all."""
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=0.1)
        except queue.Empty:
            continue
        if ok is True:
            done[rank] = value
        elif ok is False:
            errors[rank] = value
    msgs = [f"rank {r} died with exit code {p.exitcode} before its result"
            for r, p in enumerate(procs)
            if r not in done and r not in errors
            and p.exitcode not in (None, 0)]
    msgs += [f"rank {r} failed:\n{tb}" for r, tb in sorted(errors.items())]
    return RuntimeError("\n".join(msgs)) if msgs else None


def run_ranks(fn: Callable, n_ranks: int, args: Sequence = (),
              backend: str = "gloo", timeout: float = 300.0,
              collective_timeout: float = 60.0,
              threads: int = 1) -> List[Any]:
    """`fn(rank, *args)` on `n_ranks` spawned ranks; their results in rank
    order (see the module docstring)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="vut_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, name=f"rank{r}", daemon=True,
        args=(fn, r, n_ranks, os.path.join(tmp, "store"), backend,
              collective_timeout, threads, tuple(args), results))
        for r in range(n_ranks)]
    joined, done = set(), {}
    deadline = time.monotonic() + START_TIMEOUT
    try:
        for p in procs:
            p.start()
        while len(done) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                if len(joined) < n_ranks:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_ranks)) - joined)} did "
                        f"not join the process group within "
                        f"{START_TIMEOUT} s")
                raise TimeoutError(
                    f"ranks {sorted(set(range(n_ranks)) - set(done))} gave "
                    f"no result within {timeout} s of the last report")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                if any(r not in done and p.exitcode not in (None, 0)
                       for r, p in enumerate(procs)):
                    err = _failure(procs, done, results, {})
                    if err is not None:
                        raise err
                continue
            if ok == _JOINED:
                joined.add(rank)
            if ok in (_JOINED, _ALIVE):
                if len(joined) == n_ranks:  # the run's deadline, anew
                    deadline = time.monotonic() + timeout
                continue
            if not ok:
                raise _failure(procs, done, results, {rank: value})
            done[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:   # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(n_ranks)]
