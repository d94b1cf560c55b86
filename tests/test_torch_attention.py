"""K4's plain version and the port's STM memory read against the JAX
package: the Pallas flash kernel in interpret mode (out and LSE) and the
JAX `memory_read`'s einsum branch. Shapes are not tile multiples (Lq 200,
Lk 600 against the Pallas tiles of 128 and 256). Tolerance: rtol 1e-5 and
atol 1e-5, f32 sums taken in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import nn_, tt
from video_unscreen_tpu.models.stm import memory_read as j_memory_read
from video_unscreen_tpu.ops.pallas.attention import (_fwd_call, _pad_inputs,
                                                     masked_memory_attention)
from video_unscreen_tpu_torch.models.stm import memory_read
from video_unscreen_tpu_torch.ops.kernels import attention as ka

LQ, LK, DK, DV = 200, 600, 128, 512


def _masks(rng):
    stm = np.zeros(LK, np.float32)
    stm[-LQ:] = 1.0                      # bank empty, previous frame valid
    one = np.zeros(LK, np.float32)
    one[417] = 1.0
    return {"random": (rng.rand(LK) > 0.3).astype(np.float32),
            "stm": stm, "all_but_one": one,
            "none": np.zeros(LK, np.float32)}


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    q = rng.randn(LQ, DK).astype(np.float32)
    k = rng.randn(LK, DK).astype(np.float32)
    v = rng.randn(LK, DV).astype(np.float32)
    return q, k, v, _masks(rng)


def _jax_out_lse(q, k, v, mask):
    """The Pallas forward (interpret mode) with its LSE, as
    `masked_memory_attention` calls it."""
    q_p, k_p, v_p, m_p, qt, kt = _pad_inputs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        128, 256)
    out, lse = _fwd_call(q_p, k_p, v_p, m_p, qt, kt, True)
    return np.asarray(out)[:LQ], np.asarray(lse)[:LQ, 0]


@pytest.mark.parametrize("mask_name", ["random", "stm", "all_but_one",
                                       "none"])
def test_plain_matches_pallas(qkv, mask_name):
    q, k, v, masks = qkv
    mask = masks[mask_name]
    want_out, want_lse = _jax_out_lse(q, k, v, mask)
    # the public entry agrees with the forward it wraps
    np.testing.assert_array_equal(
        np.asarray(masked_memory_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), interpret=True)), want_out)
    before = (ka.ATTENTION.calls, ka.ATTENTION.launches)
    out, lse = ka.masked_memory_attention(tt(q), tt(k), tt(v), tt(mask))
    assert (ka.ATTENTION.calls, ka.ATTENTION.launches) == before
    np.testing.assert_allclose(nn_(out), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn_(lse), want_lse, rtol=1e-5, atol=1e-5)
    if mask_name == "none":
        assert not nn_(out).any() and not nn_(lse).any()
    if mask_name == "all_but_one":
        np.testing.assert_allclose(nn_(out), np.tile(v[417], (LQ, 1)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,valid", [
    (1, [[False, False, True]]),
    (1, [[True, False, True]]),
    (2, [[False, True, True], [True, True, True]]),
])
def test_memory_read_matches_jax(b, valid):
    rng = np.random.RandomState(len(valid[0]) + b)
    t, hm, wm = 3, 4, 5
    mk = rng.randn(b, t, hm, wm, DK).astype(np.float32)
    mv = rng.randn(b, t, hm, wm, DV).astype(np.float32)
    qk = rng.randn(b, hm, wm, DK).astype(np.float32)
    qv = rng.randn(b, hm, wm, DV).astype(np.float32)
    valid = np.asarray(valid)
    want = np.asarray(j_memory_read(
        jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(valid),
        jnp.asarray(qk), jnp.asarray(qv), use_pallas=False))
    got = memory_read(tt(mk), tt(mv), torch.from_numpy(valid), tt(qk),
                      tt(qv))
    assert got.shape == (b, hm, wm, 2 * DV)
    np.testing.assert_allclose(nn_(got), want, rtol=1e-5, atol=1e-5)
