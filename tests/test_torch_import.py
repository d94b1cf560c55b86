"""The PyTorch port stands alone: importing every module of
`video_unscreen_tpu_torch` (the trainers' `parallel/` modules, the native
runtime and the streamer, bg_offline, the replacement, the background
and harmonization agents, the evaluation, interactive segmentation and
the MobileNetV2 backbone, the four other trainers and the dropout, the
mesh, the rank launcher, the multi-rank dry run, the tensor-parallel
form of a model and the video probes included) loads no
JAX, flax, optax, msgpack, cv2 or JAX-package module, `chip_smoke.py`,
`tools/train_{stm,matting,binseg,human,iseg}_torch.py` and the CLIs
`tools/unscreen/{green,bg,bg_offline}_torch.py`,
`tools/replace/replace_torch.py`, `tools/eval_torch.py`,
`tools/make_eval_set_torch.py`, `tools/run_app_protocol_torch.py`,
`tools/unscreen_parallel_torch.py`, `tools/link_probe_torch.py`,
`tools/run_eval_protocol_torch.py` and `tools/profile_stages_torch.py`
import none either, and the entry
points (`FrameStreamer` and the dry run among them) refuse a missing card
instead of quietly running on the host."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "cv2",
             "video_unscreen_tpu")

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


_PORT_MODULES = {
    "video_unscreen_tpu_torch." + ".".join(
        p.relative_to(ROOT / "video_unscreen_tpu_torch").with_suffix("")
        .parts)
    for p in (ROOT / "video_unscreen_tpu_torch").rglob("*.py")}


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split()[0], out.stdout.strip().split(" ")[1:]
    assert int(n_modules) >= 20, out.stdout
    for name in ("pipeline.bg_offline", "pipeline.replace",
                 "agents.bgmodel", "agents.harmonization", "ops.metrics",
                 "pipeline.evaluate", "models.iseg", "models.mobilenetv2",
                 "agents.iseg", "utils.visualize", "parallel.train",
                 "parallel.train_seg", "parallel.train_human",
                 "parallel.train_iseg", "models.dropout", "parallel.mesh",
                 "parallel.launch", "parallel.dryrun",
                 "parallel.tensor_parallel", "ops.wirepack", "utils.video"):
        assert f"video_unscreen_tpu_torch.{name}" in _PORT_MODULES
    assert bad == [] or bad == [""], f"forbidden modules loaded: {bad}"


def _import_roots(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_nothing_of_jax():
    roots = _import_roots(ROOT / "chip_smoke.py")
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    assert "video_unscreen_tpu_torch" in roots


def _loads_nothing_of_jax(rel_path):
    roots = _import_roots(ROOT / rel_path)
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    assert "video_unscreen_tpu_torch" in roots
    probe = ("import importlib.util, sys\n"
             "spec = importlib.util.spec_from_file_location('t', "
             f"{rel_path!r})\n"
             "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
             f"print(sorted(k for k in sys.modules if k.split('.')[0] in "
             f"{set(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_trainer_imports_nothing_of_jax():
    _loads_nothing_of_jax("tools/train_stm_torch.py")


@pytest.mark.parametrize("family", ["matting", "binseg", "human", "iseg"])
def test_port_trainers_import_nothing_of_jax(family):
    _loads_nothing_of_jax(f"tools/train_{family}_torch.py")


@pytest.mark.parametrize("cli", ["unscreen/green_torch", "unscreen/bg_torch",
                                 "unscreen/bg_offline_torch",
                                 "replace/replace_torch", "eval_torch",
                                 "make_eval_set_torch",
                                 "run_app_protocol_torch",
                                 "unscreen_parallel_torch",
                                 "link_probe_torch",
                                 "run_eval_protocol_torch",
                                 "profile_stages_torch"])
def test_port_clis_import_nothing_of_jax(cli):
    _loads_nothing_of_jax(f"tools/{cli}.py")


def _cli(name):
    import importlib.util
    folder = ("replace" if name.startswith("replace") else
              "" if name in ("eval_torch", "run_app_protocol_torch")
              else "unscreen")
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry", ["pipeline", "run_fused", "bg_run",
                                   "stm_agent", "stm_train_state",
                                   "seg_agent", "run_segmented", "fused_bg",
                                   "human_seg_agent", "green_modular",
                                   "green_cli", "bg_cli", "bg_offline",
                                   "replace", "background_agent",
                                   "harmonization_agent", "bg_offline_cli",
                                   "replace_cli", "iseg_agent",
                                   "evaluate_pair", "eval_run", "eval_cli",
                                   "app_protocol_cli", "matting_train_state",
                                   "seg_train_state", "human_train_state",
                                   "iseg_train_state", "frame_streamer",
                                   "dryrun"])
def test_entry_points_refuse_missing_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not run")
    from tests.test_pipeline_bg import BG_TEST_CFG
    from tests.test_pipeline_green import TEST_CFG
    from video_unscreen_tpu_torch.agents.binseg import (HumanSegAgent,
                                                        SegAgent)
    from video_unscreen_tpu_torch.agents.stm import STMAgent
    from video_unscreen_tpu_torch.parallel.train_stm import \
        make_stm_train_state
    from video_unscreen_tpu_torch.agents.bgmodel import BackgroundAgent
    from video_unscreen_tpu_torch.agents.harmonization import \
        HarmonizationAgent
    from video_unscreen_tpu_torch.pipeline import (bg, bg_offline, green,
                                                   replace)
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    from video_unscreen_tpu_torch.pipeline.fused_green import (
        FusedGreenPipeline, run_fused)
    frames = [torch.zeros((96, 128, 3), dtype=torch.uint8).numpy()]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "pipeline":
            FusedGreenPipeline(TEST_CFG, (96, 128), work_long_side=128)
        elif entry == "run_fused":
            run_fused(TEST_CFG, frames, work_long_side=128)
        elif entry == "bg_run":
            bg.run(BG_TEST_CFG, frames)
        elif entry == "stm_agent":
            STMAgent()
        elif entry == "seg_agent":
            SegAgent()
        elif entry == "run_segmented":
            run_fused(TEST_CFG, frames * 2, work_long_side=128, segments=2)
        elif entry == "fused_bg":
            FusedBgPipeline(BG_TEST_CFG, (96, 128), work_long_side=128)
        elif entry == "human_seg_agent":
            HumanSegAgent(layers=(1, 1, 1, 1))
        elif entry == "green_modular":
            green.run(TEST_CFG, frames, save=False)
        elif entry in ("green_cli", "bg_cli", "bg_offline_cli"):
            _cli(entry.replace("_cli", "_torch")).main(
                ["-vid", "v", "--data_root", str(tmp_path)])
        elif entry == "replace_cli":
            _cli("replace_torch").main(["--data_root", str(tmp_path)])
        elif entry == "bg_offline":
            bg_offline.run(dict(BG_TEST_CFG, data={
                "dst_img_dir": str(tmp_path)}), frames, save=False)
        elif entry == "replace":
            from types import SimpleNamespace
            replace.run(SimpleNamespace(tgt_data_dir=str(tmp_path)))
        elif entry == "background_agent":
            BackgroundAgent()
        elif entry == "harmonization_agent":
            HarmonizationAgent()
        elif entry == "iseg_agent":
            from video_unscreen_tpu_torch.agents.iseg import ISegAgent
            ISegAgent()
        elif entry == "evaluate_pair":
            from video_unscreen_tpu_torch.pipeline.evaluate import \
                evaluate_pair
            evaluate_pair(frames[0][..., 0], frames[0][..., 0])
        elif entry == "eval_run":
            from video_unscreen_tpu_torch.pipeline.evaluate import run
            run({"data": {"meta_fn": str(tmp_path / "none.txt")}})
        elif entry == "eval_cli":
            _cli("eval_torch").main(["--data_root", str(tmp_path)])
        elif entry == "app_protocol_cli":
            _cli("run_app_protocol_torch").main([])
        elif entry == "matting_train_state":
            from video_unscreen_tpu_torch.parallel.train import \
                make_train_state
            make_train_state()
        elif entry == "seg_train_state":
            from video_unscreen_tpu_torch.parallel.train_seg import \
                make_seg_train_state
            make_seg_train_state()
        elif entry == "human_train_state":
            from video_unscreen_tpu_torch.models.human_parse import \
                SCHPHumanParser
            from video_unscreen_tpu_torch.parallel.train_human import \
                make_human_train_state
            make_human_train_state(model=SCHPHumanParser(
                20, layers=(1, 1, 1, 1)))
        elif entry == "frame_streamer":
            from video_unscreen_tpu_torch.parallel import FrameStreamer
            FrameStreamer(frames)
        elif entry == "dryrun":
            from video_unscreen_tpu_torch.parallel.dryrun import \
                dryrun_multichip
            dryrun_multichip(2)
        elif entry == "iseg_train_state":
            from video_unscreen_tpu_torch.parallel.train_iseg import \
                make_iseg_train_state
            make_iseg_train_state()
        else:
            make_stm_train_state()


def test_unported_options_raise():
    """Every option of the JAX constructors is ported now: the host fetch
    and the packing build (packing only with the host fetch), and what no
    JAX pipeline takes raises ValueError."""
    from tests.test_pipeline_bg import BG_TEST_CFG
    from tests.test_pipeline_green import TEST_CFG
    from video_unscreen_tpu_torch.pipeline.fused_bg import FusedBgPipeline
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline
    pipe = FusedBgPipeline(BG_TEST_CFG, (96, 128), work_long_side=128,
                           fetch="host", device="cpu")
    assert (pipe.fetch, pipe.pack_d2h) == ("host", True)
    pipe = FusedBgPipeline(BG_TEST_CFG, (96, 128), work_long_side=128,
                           pack_d2h=True, device="cpu")
    assert (pipe.fetch, pipe.pack_d2h) == ("device", False)
    with pytest.raises(ValueError, match="fetch='disk'"):
        FusedBgPipeline(BG_TEST_CFG, (96, 128), work_long_side=128,
                        fetch="disk", device="cpu")
    with pytest.raises(ValueError, match="wire='rgb'"):
        FusedGreenPipeline(TEST_CFG, (96, 128), work_long_side=128,
                           wire="rgb", device="cpu")
