"""The trainers' step on the card against the same step on the host.

Marked `cuda`: each test skips without a card. This file imports neither
JAX nor the JAX package, so on the card's machine it runs without the
suite's conftest (`-s` prints each reading as one JSON line):

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_train_cuda.py

Each family's step, for four seeds of weights and batch, is held as
`chip_smoke.py:card_vs_host` holds it (the smoke runs seed 0): the STM's
from weights/stm.msgpack at the smoke's batch 2 of 64x64 clips, the four
others' on their reduced models at their tools' batch and size, the
float32 gradients to `chip_smoke.GRAD_L2`, the float64 ones to 1e-6,
the parameters to AdamW's first step on each device's own gradients, the
BatchNorm statistics to 1e-4, and a TF32 control that must break the
float32 bound. These runs are the readings `GRAD_L2` was set from."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

# imported by its own name, as tests/test_torch_kernels_cuda.py does
from torch_port_util import cuda, require_cuda

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["stm", "matting", "binseg", "human",
                                  "iseg"])
def test_card_step_matches_host(name, seed):
    require_cuda()
    smoke = _smoke()
    if name == "stm":
        r = smoke.stm_card_vs_host(ROOT / "weights" / "stm.msgpack", seed)
    else:
        r = smoke.family_card_vs_host(name, seed)
    print(json.dumps({"family": name, "seed": seed, **r}))
    assert max(r["tensors"], r["whole"], r["params"], r["stats"],
               r["float64"]) <= 1.0 < r["tf32_whole"]
