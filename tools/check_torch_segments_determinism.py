#!/usr/bin/env python3
"""Which values of green's `process_segments` differ between runs on the
card, and whether cuDNN's deterministic mode removes the difference.

    python tools/check_torch_segments_determinism.py

`chip_smoke.py` phase 13's input (S = 4 segments x 2 frames at 1080p ->
544x960, float32, chroma seed) through `process_segments` on this
process's one-rank mesh: twice here and once in each of two spawned
processes with cuDNN's default algorithms, then twice under
`torch.use_deterministic_algorithms(True, warn_only=True)` (here and in a
spawned process), printing the operations it warns about and, for each
pair, the values that differ. Prints the card's name and power limit.
Exits 2 without CUDA.
"""
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def run(deterministic=False):
    """(packed, screen colors) of the phase's segments, in numpy."""
    import torch
    import chip_smoke as cs
    from video_unscreen_tpu_torch.parallel.mesh import make_mesh
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    with torch.inference_mode():
        outs = cs.ranks_pipe("green").process_segments(make_mesh(1),
                                                       cs.rank_clip())
    return [o.cpu().numpy() for o in outs]


def rank_run(rank, deterministic):
    return run(deterministic)


def describe(what, got, want):
    import numpy as np
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g.astype(np.float64) - w.astype(np.float64))
        where = np.argwhere(d > 0)
        print(f"{what}, output {i}: {len(where)} values differ (max "
              f"{d.max()}); the first at {where[:5].tolist()}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("check_torch_segments_determinism: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from video_unscreen_tpu_torch.ops.kernels import build
    from video_unscreen_tpu_torch.parallel.launch import run_ranks
    build.build()   # before the spawns
    print(cs.smi_line(), flush=True)
    first = run()
    describe("default, a second run in this process", run(), first)
    for trial in range(2):
        (other,) = run_ranks(rank_run, 1, (False,), timeout=600)
        describe(f"default, spawned process {trial + 1}", other, first)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        exact = run(deterministic=True)
    print("operations without a deterministic version: "
          f"{sorted({str(w.message)[:160] for w in caught}) or 'none'}",
          flush=True)
    describe("deterministic against the first default run", exact, first)
    (other,) = run_ranks(rank_run, 1, (True,), timeout=600)
    describe("deterministic, a spawned process", other, exact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
