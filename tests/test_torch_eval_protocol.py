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
import pytest

from tests.test_pipeline_green import TEST_CFG
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
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


def test_protocol_run_then_score(tmp_path):
    """`--only run` writes the predictions and no table; `--only score`
    then scores them (the eval set is not made again) as one call does."""
    root = tmp_path / "eval"
    cfg = tmp_path / "green.json"
    cfg.write_text(json.dumps({k: v for k, v in TEST_CFG.items()
                               if k != "data"}))
    common = ["--data_root", str(root), "--modes", "green", "--vids",
              "green2", "--frames", "3", "--height", "64", "--width", "96",
              "--work_long_side", "96", "--green_cfg", str(cfg),
              "--device", "cpu"]
    tool = _tool()
    assert tool.main(common + ["--only", "run", "--results_dir",
                               str(tmp_path / "run")]) == {}
    assert not (tmp_path / "run" / "protocol.md").exists()
    preds = sorted(glob(osp.join(root, "test_green_img", "green2",
                                 "alphamask_*.jpg")))
    assert len(preds) == 3
    (root / "src_img").rename(tmp_path / "src_img")   # not read again
    rows = tool.main(common + ["--only", "score", "--results_dir",
                               str(tmp_path / "score")])
    gts = sorted(glob(osp.join(root, "alpha_img", "green2", "*.*")))
    want = {k: float(np.mean(v)) for k, v in
            evaluate.evaluate_video(gts, preds, "cpu").items()}
    assert rows["green"]["green2"] == want
    assert (tmp_path / "score" / "protocol.md").exists()


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
        with pytest.raises(SystemExit) as exc:
            mod.main([])
        assert exc.value.code == 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(name):
    """The green rows of a table of record as {clip: its five cells as
    printed}."""
    out = {}
    for line in (ROOT / "results" / name).read_text().splitlines()[2:]:
        mode, vid, *cells = [c.strip() for c in line.strip("|").split("|")]
        if mode == "green":
            out[vid] = cells
    return out


def test_chip_smoke_protocol_rows_are_the_record():
    """`chip_smoke.py`'s copy of the green rows of the JAX tables of
    record, digit for digit, in the record's own formats."""
    fmts = ("{:.4f}", "{:.3f}", "{:.4f}", "{:.3f}", "{:.3f}")
    rows = _chip_smoke().PROTOCOL_JAX
    assert set(rows) == {"bgr", "yuv420"}
    for wire, name in (("bgr", "protocol_960.md"),
                       ("yuv420", "protocol_960_yuv420.md")):
        want = _record(name)
        assert len(want) == 6, name      # the 5 green clips and ALL
        got = {vid: [f.format(v) for f, v in zip(fmts, m)]
               for vid, m in rows[wire].items()}
        assert got == want, wire


def test_chip_smoke_protocol_check_bound():
    cs = _chip_smoke()
    assert cs.PROTOCOL_MIOU_TOL == 0.01
    want = cs.PROTOCOL_JAX["yuv420"]["green2"][0]
    for off in (0.009, -0.009):
        assert abs(cs.protocol_check("yuv420", "green2", want + off)
                   - off) < 1e-12
    for off in (0.011, -0.011):
        with pytest.raises(RuntimeError, match="green2"):
            cs.protocol_check("yuv420", "green2", want + off)
