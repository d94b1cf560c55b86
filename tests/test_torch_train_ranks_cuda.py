"""The STM's training over ranks on the card: `chip_smoke.py` phase 14
for the STM alone.

Marked `cuda`: each test skips without a card. This file imports neither
JAX nor the JAX package, so on the card's machine it runs without the
suite's conftest (`-s` prints the phase's readings as one JSON line):

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_train_ranks_cuda.py

Four `gloo` ranks share the card as (data 2, model 2) and take the STM's
tool defaults (batch 8 of 128x128 clips of 3 frames, seeded weights)
for 3 steps: the first step's loss to 1e-5 relative, the gradients by
`chip_smoke.GRAD_L2`'s STM bounds and the BatchNorm statistics to 1e-5
against one process stepping the whole batch; K4, K5 and K6 one call a
step on every rank; then one NCCL rank on the (1, 1) mesh bit-equal to
the mesh-less step. The ranks' function lives in `chip_smoke.py`, which
the spawned ranks import by name (so the repository's root is put on the
path first)."""
import importlib
import json
import sys
from pathlib import Path

import torch

# imported by its own name, as tests/test_torch_kernels_cuda.py does
from torch_port_util import cuda, require_cuda

ROOT = Path(__file__).resolve().parents[1]


@cuda
def test_stm_training_over_ranks_on_the_card():
    require_cuda()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    from video_unscreen_tpu_torch.ops.kernels import build
    build.build()   # once, before the ranks load it
    counts, report = smoke.train_ranks_phase(torch.device("cuda"), ("stm",))
    print(json.dumps(report))
    for r in range(smoke.TRAIN_RANKS):
        calls = counts[f"train_ranks_stm_r{r}"]
        for name in smoke.READ:
            assert calls[name][0] == smoke.TRAIN_RANK_STEPS, (r, calls)
    assert report["stm"]["grads_whole"] <= 1.0
    assert report["stm"]["stats"] <= 1.0
