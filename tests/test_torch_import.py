"""The PyTorch port stands alone: importing every module of
`video_unscreen_tpu_torch` loads no JAX, flax, msgpack, cv2 or JAX-package
module, `chip_smoke.py` imports none either, and the entry points refuse a
missing card instead of quietly running on the host."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "cv2", "video_unscreen_tpu")

_PROBE = """
import importlib, pkgutil, sys
import video_unscreen_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in {forbidden!r})
print(len(names), ",".join(bad))
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split()[0], out.stdout.strip().split(" ")[1:]
    assert int(n_modules) >= 20, out.stdout
    assert bad == [] or bad == [""], f"forbidden modules loaded: {bad}"


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    assert "video_unscreen_tpu_torch" in roots


@pytest.mark.parametrize("entry", ["pipeline", "run_fused"])
def test_entry_points_refuse_missing_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not run")
    from tests.test_pipeline_green import TEST_CFG
    from video_unscreen_tpu_torch.pipeline.fused_green import (
        FusedGreenPipeline, run_fused)
    frames = [torch.zeros((96, 128, 3), dtype=torch.uint8).numpy()]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "pipeline":
            FusedGreenPipeline(TEST_CFG, (96, 128), work_long_side=128)
        else:
            run_fused(TEST_CFG, frames, work_long_side=128)


def test_unported_options_raise():
    from tests.test_pipeline_green import TEST_CFG
    from video_unscreen_tpu_torch.pipeline.fused_green import (
        FusedGreenPipeline, run_fused)
    with pytest.raises(NotImplementedError):
        run_fused(TEST_CFG, [], save=True, device="cpu")
    cfg = dict(TEST_CFG, binseg={"type": "deeplab",
                                 "model_path": "weights/x.msgpack"})
    with pytest.raises(NotImplementedError):
        FusedGreenPipeline(cfg, (96, 128), work_long_side=128, device="cpu")
