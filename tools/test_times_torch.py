"""Where a tier-1 run's time goes, from the junit XML that pytest writes
(`--junitxml`; the tier-1 command writes /tmp/_t1.xml).

    python tools/test_times_torch.py /tmp/_t1.xml [--schedule]
        [--before OLD.xml --match test_torch_]

Prints the 15 files with the largest sums of their tests' times (setup,
call and teardown, as junit counts them: a module fixture's cost lands on
the file's first test), the 15 slowest tests, and the run replayed as the
tier-1 command's `pytest -n 6 --dist loadfile` schedules it (with
`--schedule`, each file's start): whole files to workers, the files with
the most tests first (xdist's default reorder), a worker taking its next
file once at most 2 of its tests are left. The replay's wall time is the
largest worker's sum; a file of few tests goes late, so a long one sets
the tail. With `--before`, each file's sum in an earlier run's XML beside
this one's (the files whose path holds `--match`). Times are those of
the run read, on its machine and under its load.
"""

from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

TOP = 15  # files and tests listed
WORKERS = 6  # the tier-1 command's xdist workers


def read(path: str) -> Dict[str, List[Tuple[str, float, bool]]]:
    """file -> [(test name, seconds, passed)] in the XML's order."""
    files: Dict[str, List[Tuple[str, float, bool]]] = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")   # tests.<file>[.<class>]
        test = "::".join(parts[2:] + [case.get("name")])
        passed = not any(case.find(k) is not None
                         for k in ("skipped", "failure", "error"))
        files.setdefault(f"tests/{parts[1]}.py", []).append(
            (test, float(case.get("time") or 0.0), passed))
    return files


def replay(files: Dict[str, List[float]], workers: int):
    """(wall seconds, each worker's seconds, [(start, worker, file)])."""
    order = sorted(files, key=lambda f: (-len(files[f]), f))
    queue = collections.deque(order)
    clock = [0.0] * workers
    pending = [collections.deque() for _ in range(workers)]
    starts = []

    def assign(w):
        if queue:
            f = queue.popleft()
            starts.append((clock[w], w, f))
            pending[w].extend(files[f])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((k for k in range(workers) if pending[k]),
                key=lambda k: clock[k])
        clock[w] += pending[w].popleft()
        if len(pending[w]) <= 2:
            assign(w)
    return max(clock), clock, starts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--schedule", action="store_true",
                    help="also print each file's start in the replay")
    ap.add_argument("--before", help="an earlier run's junit XML")
    ap.add_argument("--match", default="",
                    help="with --before: only files whose path holds this")
    args = ap.parse_args(argv)
    files = read(args.xml)
    sums = {f: sum(t for _, t, _ in v) for f, v in files.items()}
    total = sum(sums.values())
    print(f"{sum(len(v) for v in files.values())} tests, "
          f"{sum(p for v in files.values() for *_, p in v)} passed, "
          f"{total:.1f} s summed over {len(files)} files")
    print(f"files by time (top {TOP}):")
    for f in sorted(sums, key=sums.get, reverse=True)[:TOP]:
        print(f"  {sums[f]:8.1f} s  {f}  ({len(files[f])} tests)")
    print(f"tests by time (top {TOP}):")
    tests = sorted(((t, f"{f}::{n}") for f, v in files.items()
                    for n, t, _ in v), reverse=True)
    for t, name in tests[:TOP]:
        print(f"  {t:8.1f} s  {name}")
    wall, clock, starts = replay(
        {f: [t for _, t, _ in v] for f, v in files.items()}, WORKERS)
    print(f"replayed over {WORKERS} workers (--dist loadfile): "
          f"{wall:.1f} s; workers "
          + ", ".join(f"{c:.1f}" for c in clock)
          + f"; one sixth of the wall {wall / 6:.1f} s")
    if args.schedule:
        for start, w, f in starts:
            print(f"  {start:8.1f} s  gw{w}  {f}  ({sums[f]:.1f} s)")
    if args.before:
        old = {f: sum(t for _, t, _ in v)
               for f, v in read(args.before).items()}
        names = sorted((set(old) | set(sums)),
                       key=lambda f: (-old.get(f, 0.0), f))
        print("before  after  (s, each file's sum)")
        for f in names:
            if args.match in f:
                print(f"  {old.get(f, 0.0):8.1f} {sums.get(f, 0.0):8.1f}  "
                      f"{f}")


if __name__ == "__main__":
    main()
