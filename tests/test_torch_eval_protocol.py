"""`tools/run_eval_protocol_torch.py` end to end on the CPU at a tiny size:
the eval set made by the port (3 frames of 64x96 a clip), green mode on
two of its clips with the test config's chroma seed, and the table: each
clip's row holds the scores `pipeline/evaluate.py` gives on the
predictions the run wrote, and the results land in `--results_dir`.
Also the other two tools of the slice on the host: `tools/link_probe_torch
.py --device cpu` prints JAX's two lines and its figures, and
`tools/profile_stages_torch.py`, a card's tool, exits 2 without CUDA
after building its stages here."""
import importlib.util
import json
import os.path as osp
from glob import glob
from pathlib import Path

import numpy as np

from tests.test_pipeline_green import TEST_CFG
from tests.torch_port_util import require_cuda  # noqa: F401 (thread cap)
from video_unscreen_tpu_torch.pipeline import evaluate

ROOT = Path(__file__).resolve().parents[1]


def _tool(name="run_eval_protocol_torch"):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_green_protocol_table(tmp_path):
    root, results = tmp_path / "eval", tmp_path / "results"
    cfg = tmp_path / "green.json"
    cfg.write_text(json.dumps({k: v for k, v in TEST_CFG.items()
                               if k != "data"}))
    rows = _tool().main([
        "--data_root", str(root), "--modes", "green",
        "--vids", "green1,green2", "--frames", "3", "--height", "64",
        "--width", "96", "--work_long_side", "96",
        "--green_cfg", str(cfg), "--results_dir", str(results),
        "--device", "cpu"])
    assert set(rows["green"]) == {"green1", "green2", "ALL"}
    table = (results / "protocol.md").read_text()
    assert (results / "test_green.txt").exists()
    for vid in ("green1", "green2"):
        gts = sorted(glob(osp.join(root, "alpha_img", vid, "*.*")))
        preds = sorted(glob(osp.join(root, "test_green_img", vid,
                                     "alphamask_*.jpg")))
        assert len(gts) == len(preds) == 3
        want = {k: float(np.mean(v)) for k, v in
                evaluate.evaluate_video(gts, preds, "cpu").items()}
        assert rows["green"][vid] == want
        m = want
        assert (f"| green | {vid} | {m['miou']:.4f} | {m['sad']:.3f} | "
                f"{m['mse']:.4f} | {m['grad']:.3f} | {m['conn']:.3f} |"
                in table)
        assert m["miou"] > 0.5


def test_link_probe_on_host(capsys):
    r = _tool("link_probe_torch").main(["--device", "cpu", "--mb", "1",
                                        "--repeats", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("h2d: ") and "duplex(2x1MB)" in out[0]
    assert out[1].startswith("duplex time / serialized time: ")
    assert json.loads(out[-1])["link_probe"] == r
    for key in ("h2d_pinned", "d2h_pinned", "d2h_pageable",
                "duplex_aggregate", "overlap"):
        assert np.isfinite(r[key]) and r[key] > 0, key


def test_profile_stages_builds_its_stages():
    import torch
    mod = _tool("profile_stages_torch")
    names = []
    with torch.inference_mode():
        for name, fn in mod.stages(64, 96, torch.device("cpu")):
            fn()
            names.append(name)
    assert names == ["cc_stats_ds", "i420_to_bgr", "regionfill_200",
                     "regionfill_50", "regionfill3_cold", "regionfill3_warm",
                     "pack_plane", "pack_plane_bg"]
    if not torch.cuda.is_available():
        import pytest
        with pytest.raises(SystemExit) as exc:
            mod.main([])
        assert exc.value.code == 2
