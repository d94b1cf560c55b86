"""`tests/torch_jax_cache.py:cache_every_compile`: every port test module
that runs JAX imports it, and in such a module the persistent cache
keeps every program."""
import re
from pathlib import Path

import jax

from tests.torch_jax_cache import cache_every_compile  # noqa: F401

TESTS = Path(__file__).resolve().parent
# a module that imports JAX, flax, the JAX package or a helper that runs
# them (the JAX suite's test modules, the trainers' JAX helper)
RUNS_JAX = re.compile(
    r"^(import (jax|flax)\b|from (jax|flax)\b|from video_unscreen_tpu(\.| )"
    r"|from tests\.(test_|torch_train_util\b))", re.M)
IMPORTS_FIXTURE = re.compile(
    r"^from tests\.torch_jax_cache import cache_every_compile\b", re.M)


def test_every_port_module_that_runs_jax_imports_it():
    runs_jax = [p for p in sorted(TESTS.glob("test_torch_*.py"))
                if RUNS_JAX.search(p.read_text())]
    assert len(runs_jax) > 40
    missing = [p.name for p in runs_jax
               if not IMPORTS_FIXTURE.search(p.read_text())]
    assert not missing, missing


def test_the_cache_keeps_every_program_here():
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
