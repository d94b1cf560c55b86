"""The port's mesh rule, rank launcher, `FrameStreamer`, per-video fan-out
and multi-rank dry run, on the CPU.

Mirrors the inference cases of `tests/test_parallel.py`: the mesh shape
(`make_mesh` over 2 and 3 spawned `gloo` ranks and the rule for 1-8),
`test_frame_streamer` (chunks of 4 of 10 frames), the device of each
video (`tools/unscreen_parallel_torch.py` with its launcher stubbed, no
process run) and `select_device` on unset, out-of-range and malformed
ids, and `test_graft_entry_multichip`'s lines (`parallel/dryrun.py` on 4
ranks: the training step's line, then the two inference lines). The
launcher's failures: a rank that raises, one that dies and one that
hangs each fail the call within seconds; a rank that reports progress
keeps its deadline moving. Imports no JAX: the reference values are
JAX's rules, restated.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_rank_cases as cases
from tests.torch_port_util import assert_equal
from video_unscreen_tpu_torch.config import select_device
from video_unscreen_tpu_torch.parallel import FrameStreamer, make_mesh
from video_unscreen_tpu_torch.parallel.dryrun import dryrun_multichip
from video_unscreen_tpu_torch.parallel.launch import run_ranks
from video_unscreen_tpu_torch.parallel.mesh import (batch_sharding,
                                                    mesh_shape, replicate)
from video_unscreen_tpu_torch.utils.fileio import write_png

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)),
                                    (4, (2, 2)), (6, (3, 2)), (8, (4, 2))])
def test_mesh_shape_rule(n, want):
    assert mesh_shape(n) == want


@pytest.mark.parametrize("n", [2, 3])
def test_make_mesh_over_ranks(n):
    got = run_ranks(cases.mesh_of, n, (n,), timeout=60)
    shape = dict(zip(("data", "model"), mesh_shape(n)))
    for rank, (s, coords) in enumerate(got):
        assert s == shape
        assert coords == {"data": rank // shape["model"],
                          "model": rank % shape["model"]}


def test_make_mesh_without_process_group():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis("model") is None
    x = torch.arange(6).reshape(3, 2)
    for sharding in (batch_sharding(mesh), replicate(mesh)):
        assert_equal(sharding.gather(sharding.shard(x)), x)
    with pytest.raises(ValueError, match="covers every rank"):
        make_mesh(2)


@pytest.mark.parametrize("fn,match", [
    (cases.rank1_raises, "rank 1 fails on purpose"),
    (cases.rank0_dies, "rank 0 died with exit code 3"),
    (cases.rank1_hangs, "gave no result within")])
def test_run_ranks_fails_fast(fn, match):
    with pytest.raises((RuntimeError, TimeoutError), match=match):
        run_ranks(fn, 2, timeout=6)


def test_run_ranks_deadline_runs_from_the_last_report():
    """Nine naps of 1 s with a `heartbeat` after each outlast the 6 s
    deadline and finish: the deadline runs from the last report (without
    one, `rank1_hangs` above fails). A report comes 5 s before it is due,
    so a loaded host does not fail the test."""
    assert run_ranks(cases.naps_with_reports, 2, (9, 1.0), timeout=6) == [
        0, 1]


def test_frame_streamer():
    frames = [np.full((8, 8, 3), i, np.uint8) for i in range(10)]
    chunks = list(FrameStreamer(frames, chunk_size=4, device="cpu"))
    assert len(chunks) == 3
    assert chunks[0].shape == (4, 8, 8, 3)
    assert chunks[-1].shape == (2, 8, 8, 3)
    np.testing.assert_allclose(np.asarray(chunks[1])[0, 0, 0, 0], 4.0)
    # each chunk is a tensor of its own, not the stream's reused buffer
    assert [int(c[0, 0, 0, 0]) for c in chunks] == [0, 4, 8]


def test_frame_streamer_paths_and_preprocess(tmp_path):
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"f{i}.png"))
        write_png(paths[-1], np.full((6, 10, 3), 10 * i, np.uint8))
    chunks = list(FrameStreamer(paths, chunk_size=2, device="cpu",
                                preprocess=lambda a: a.astype(np.float32)
                                / 2, prefetch=1))
    assert [tuple(c.shape) for c in chunks] == [(2, 6, 10, 3)] * 2 + [
        (1, 6, 10, 3)]
    assert all(c.dtype == torch.float32 for c in chunks)
    assert [float(v) for c in chunks for v in c[:, 0, 0, 0]] == [
        0.0, 5.0, 10.0, 15.0, 20.0]


def _fan_out():
    spec = importlib.util.spec_from_file_location(
        "unscreen_parallel_torch", ROOT / "tools" /
        "unscreen_parallel_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_unscreen_parallel_maps_video_i_to_device_i_mod_n(tmp_path, capsys):
    (tmp_path / "meta").mkdir()
    vids = [f"clip{i}" for i in range(7)]
    (tmp_path / "meta" / "vid_list.txt").write_text("\n".join(vids) + "\n")
    calls = []

    def call(argv, env):
        calls.append((argv, env["UNSCREEN_DATA_ROOT"]))
        return 0 if argv[3] != "clip4" else 1

    failed = _fan_out().main(["--script", "bg", "--workers", "3",
                              "--data_root", str(tmp_path)], call=call)
    assert failed == 1
    assert sorted(calls) == sorted(
        (["bash", "tools/unscreen_torch.sh", "bg", v, str(i % 3)],
         str(tmp_path)) for i, v in enumerate(vids))
    assert "Videos Done: 7 (6 ok)" in capsys.readouterr().out

    calls.clear()
    _fan_out().main(["--range", "2-5", "--data_root", str(tmp_path)],
                    call=call)
    assert [c[0][3:] for c in calls] == [[v, "0"] for v in vids[2:5]]


def test_select_device_unset_and_out_of_range(monkeypatch):
    monkeypatch.delenv("UNSCREEN_DEVICE_ID", raising=False)
    assert select_device() is None
    for raw in ("9999", "not-a-device", "-1"):
        monkeypatch.setenv("UNSCREEN_DEVICE_ID", raw)
        assert select_device() is None
    if not torch.cuda.is_available():   # no card: no id names one
        monkeypatch.setenv("UNSCREEN_DEVICE_ID", "0")
        assert select_device() is None


def test_dryrun_inference_four_ranks(capsys):
    lines = dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert len(lines) == 3
    assert re.fullmatch(r"dryrun_multichip ok: mesh=\{'data': 2, 'model': "
                        r"2\} loss=\d+\.\d{4}", lines[0]), lines[0]
    assert lines[1:] == [
        "dryrun_multichip green inference ok: 4 segments x 2 frames "
        "sharded over data=2, seed TTA crops sharded over model=2 (2-axis "
        "inference)",
        "dryrun_multichip bg inference ok: 4 segments x 2 frames sharded "
        "over data=2"]
    assert [line for line in out.splitlines()
            if line.startswith("dryrun_multichip")] == lines
