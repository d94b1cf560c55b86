"""`cache_every_compile`: a module-scoped autouse fixture that every port
test module running JAX imports (`from tests.torch_jax_cache import
cache_every_compile  # noqa: F401`).

`tests/conftest.py` points JAX at a persistent compilation cache but
writes only programs that took 0.5 s or more to compile. A port test's
JAX reference runs flax models op by op (their `init`, an un-jitted
`apply`, a float64 value-and-grad), and every primitive at a new shape is
a program of its own that compiles in ~0.1 s: 800 to 1000 of them in each
of the heavy model files, recompiled in every run, about 80 s a file on
one core. While a port module runs, this fixture writes every program to
the cache, so a later run loads them. The executables are the ones the
compiler made, so every value is unchanged; only the first run in a fresh
cache pays the writes. The JAX package's own test modules keep the
conftest's rule.

This module imports JAX: only the CPU suite uses it."""
import jax
import pytest

_MIN_SECS = "jax_persistent_cache_min_compile_time_secs"


@pytest.fixture(scope="module", autouse=True)
def cache_every_compile():
    before = getattr(jax.config, _MIN_SECS)
    jax.config.update(_MIN_SECS, 0.0)
    yield
    jax.config.update(_MIN_SECS, before)
