"""Shared helpers of the PyTorch-port tests (`tests/test_torch_*.py`).

- Caps torch at one thread: the suite runs six xdist workers on shared
  cores.
- `cuda` is the marker of tests that need an NVIDIA card (registered in
  pyproject.toml); such a test calls `require_cuda()` first, so the
  decision is made when it runs, never at import.
- `assert_bf16_close` holds a bfloat16 output of the port to the JAX
  package's bfloat16 output by their mean difference, at a bound that a
  float32 side against a bfloat16 one exceeds.
- `compare` runs one numpy input, made from a seed, through a JAX function
  and its port and holds the outputs together.

This module imports neither JAX nor the JAX package, so the card-only tests
can use it on a machine without JAX.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

cuda = pytest.mark.cuda


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


def tt(a, device="cpu") -> torch.Tensor:
    """numpy -> torch (float arrays as float32)."""
    a = np.array(a)  # a writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def nn_(x) -> np.ndarray:
    """torch tensor or JAX/numpy array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol=1e-5, what=""):
    """max |got - want| <= rtol * max(1, max |want|): relative to the
    array's scale, so values near 0 in a 0..255 map are not held to 1e-5
    of themselves."""
    got = nn_(got).astype(np.float64)
    want = nn_(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} * {scale}"


def mean_rel_err(got, want) -> float:
    """mean |got - want| / mean |want|."""
    got = nn_(got).astype(np.float64)
    want = nn_(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def assert_bf16_close(got, want, bound, cross, what=""):
    """bfloat16 against bfloat16: mean |got - want| <= bound * mean |want|.
    XLA keeps excess precision inside its fused bfloat16 chains, so two
    bfloat16 runs agree only to a fraction of bfloat16's own error; the
    bound is held to that size by `cross`, pairs of a float32 output
    against a bfloat16 one, each of which must exceed it."""
    err = mean_rel_err(got, want)
    errs = [mean_rel_err(g, w) for g, w in cross]
    assert err <= bound, f"{what}: mean relative |diff| {err} > {bound}"
    assert min(errs) > bound, (f"{what}: float32 against bfloat16 is within "
                               f"the bound: {errs} <= {bound}")


def assert_equal(got, want, what=""):
    got, want = nn_(got), nn_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def compare(jax_fn, torch_fn, *inputs, rtol=1e-5, exact=False, what=""):
    """Run numpy `inputs` through both functions and compare every output."""
    want = jax_fn(*inputs)
    got = torch_fn(*[tt(a) for a in inputs])
    if not isinstance(want, (tuple, list)):
        want, got = (want,), (got,)
    assert len(want) == len(got), what
    for i, (g, w) in enumerate(zip(got, want)):
        if exact:
            assert_equal(g, w, f"{what}[{i}]")
        else:
            assert_close(g, w, rtol, f"{what}[{i}]")


def soft_mask(h, w, seed=0):
    """Soft ellipse with a speckle of 200s: grayscale, not binary, input
    for morphology (the pattern of tests/test_pallas_morph.py)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w), np.float32)
    a[((yy - h // 2) ** 2 / (h * 0.3) ** 2
       + (xx - w // 3) ** 2 / (w * 0.2) ** 2) < 1.0] = 255.0
    a *= rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    a[rng.rand(h, w) < 0.002] = 200.0
    return a


def blob_mask(h, w, seed=0, speckle=0.01):
    """Binary 0/255 mask: two ellipses plus isolated speckle."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w), np.float32)
    a[((yy - h // 2) ** 2 / (h * 0.3) ** 2
       + (xx - w // 3) ** 2 / (w * 0.15) ** 2) < 1.0] = 255.0
    a[((yy - h // 4) ** 2 / (h * 0.1) ** 2
       + (xx - 3 * w // 4) ** 2 / (w * 0.08) ** 2) < 1.0] = 255.0
    a[rng.rand(h, w) < speckle] = 255.0
    return a
