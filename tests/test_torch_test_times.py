"""`tools/test_times_torch.py`, the suite's time per file from pytest's
junit XML and its replay as `--dist loadfile` schedules it, on a small
hand-written XML."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

XML = """<?xml version="1.0" encoding="utf-8"?>
<testsuites><testsuite name="pytest" errors="0" failures="1" skipped="1"
 tests="7" time="9.0">
<testcase classname="tests.test_a" name="test_x[1]" time="4.0" />
<testcase classname="tests.test_a" name="test_x[2]" time="1.0">
 <skipped message="no card" /></testcase>
<testcase classname="tests.test_a" name="test_y" time="1.0" />
<testcase classname="tests.test_b.TestK" name="test_z" time="2.5" />
<testcase classname="tests.test_b.TestK" name="test_w" time="0.5">
 <failure message="boom" /></testcase>
<testcase classname="tests.test_c" name="test_v" time="3.0" />
<testcase classname="tests.test_d" name="test_u" time="1.0" />
</testsuite></testsuites>
"""


def _tool():
    spec = importlib.util.spec_from_file_location(
        "test_times_torch", ROOT / "tools" / "test_times_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def xml(tmp_path):
    path = tmp_path / "t1.xml"
    path.write_text(XML)
    return str(path)


def test_read_sums_by_file_and_keeps_class_names(xml):
    files = _tool().read(xml)
    assert list(files) == ["tests/test_a.py", "tests/test_b.py",
                           "tests/test_c.py", "tests/test_d.py"]
    assert [n for n, *_ in files["tests/test_b.py"]] == [
        "TestK::test_z", "TestK::test_w"]
    assert sum(t for _, t, _ in files["tests/test_a.py"]) == 6.0
    assert [p for *_, p in files["tests/test_a.py"]] == [True, False, True]
    assert [p for *_, p in files["tests/test_b.py"]] == [True, False]


def test_replay_takes_files_by_count_then_name():
    """The most tests first, ties by name; a worker takes its next file
    once at most 2 of its tests are left. One worker runs the files one
    after another (the wall is the sum); of two, the second takes test_c
    at once (test_b leaves it 2 tests) and the first takes test_d after
    its first test."""
    replay = _tool().replay
    files = {"tests/test_a.py": [4.0, 1.0, 1.0], "tests/test_b.py": [2.5,
                                                                     0.5],
             "tests/test_c.py": [3.0], "tests/test_d.py": [1.0]}
    wall, clock, starts = replay(files, 1)
    assert wall == clock[0] == 13.0
    assert [f for *_, f in starts] == ["tests/test_a.py", "tests/test_b.py",
                                       "tests/test_c.py", "tests/test_d.py"]
    wall, clock, starts = replay(files, 2)
    assert [(s, w, f) for s, w, f in starts] == [
        (0.0, 0, "tests/test_a.py"), (0.0, 1, "tests/test_b.py"),
        (0.0, 1, "tests/test_c.py"), (4.0, 0, "tests/test_d.py")]
    assert clock == [7.0, 6.0] and wall == 7.0


def test_main_prints_the_tables(xml, capsys):
    _tool().main([xml, "--schedule"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == (
        "7 tests, 5 passed, 13.0 s summed over 4 files")
    assert "     6.0 s  tests/test_a.py  (3 tests)" in out
    assert "     4.0 s  tests/test_a.py::test_x[1]" in out
    # 4 files on 6 workers: each its own worker from the start
    assert "replayed over 6 workers (--dist loadfile): 6.0 s" in out
    assert "       0.0 s  gw3  tests/test_d.py  (1.0 s)" in out


def test_before_and_after_by_file(xml, tmp_path, capsys):
    """`--before`: each matching file's sum in both runs, a file that one
    run lacks at 0, in the order of the earlier run's sums."""
    old = tmp_path / "old.xml"
    old.write_text(XML.replace('"tests.test_d"', '"tests.test_e"').replace(
        'name="test_v" time="3.0"', 'name="test_v" time="9.0"'))
    _tool().main([xml, "--before", str(old), "--match", "test_"])
    out = capsys.readouterr().out
    table = out[out.index("before  after"):].splitlines()[1:]
    assert table == [
        "       9.0      3.0  tests/test_c.py",
        "       6.0      6.0  tests/test_a.py",
        "       3.0      3.0  tests/test_b.py",
        "       1.0      0.0  tests/test_e.py",
        "       0.0      1.0  tests/test_d.py"]
