"""K4's plain version and the port's STM memory read against the JAX
package: the Pallas flash kernel in interpret mode (out and LSE), alone
and vmapped over a batch as the JAX STM reads, and the JAX `memory_read`'s
einsum branch. Shapes are not tile multiples (Lq 200, Lk 600 against the
Pallas tiles of 128 and 256). Tolerance: rtol 1e-5 and atol 1e-5, f32 sums
taken in another order. Then the 3xTF32 products of K4 and K5, emulated in
torch, against the card's check."""
import jax
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


def _batch_masks(lk, rng):
    """Three items whose fully masked 64-key tiles lie at the start and
    the end (item 0) and in the middle (item 1); item 2 has no valid
    key."""
    m = (rng.rand(3, lk) > 0.3).astype(np.float32)
    m[0, :128] = 0.0
    m[0, 4 * 64:] = 0.0
    m[1, 2 * 64:3 * 64] = 0.0
    m[2] = 0.0
    return m


def test_batched_plain_matches_vmapped_pallas():
    """The batched plain forward (B 3) against `jax.vmap` of the Pallas
    forward, out and LSE; each item also as its own 2-D call."""
    rng = np.random.RandomState(8)
    b, lq, lk, dk, dv = 3, 70, 300, 64, 128
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((b, lq, dk), (b, lk, dk), (b, lk, dv)))
    mask = _batch_masks(lk, rng)

    def one(a, b_, c, m):
        return _fwd_call(*_pad_inputs(a, b_, c, m, 128, 256), True)

    want_out, want_lse = jax.vmap(one)(*map(jnp.asarray, (q, k, v, mask)))
    want_out = np.asarray(want_out)[:, :lq]
    want_lse = np.asarray(want_lse)[:, :lq, 0]
    out, lse = ka.masked_memory_attention(tt(q), tt(k), tt(v), tt(mask))
    assert out.shape == (b, lq, dv) and lse.shape == (b, lq)
    np.testing.assert_allclose(nn_(out), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn_(lse), want_lse, rtol=1e-5, atol=1e-5)
    assert not nn_(out)[2].any() and not nn_(lse)[2].any()
    for i in range(b):
        o, l_ = ka.attention_plain(tt(q[i]), tt(k[i]), tt(v[i]),
                                   tt(mask[i]))
        np.testing.assert_allclose(nn_(o), nn_(out)[i], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(nn_(l_), nn_(lse)[i], rtol=1e-5,
                                   atol=1e-5)


# -- 3xTF32 ---------------------------------------------------------------
def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32` rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """a @ b on operands rounded as the tensor cores take them: one TF32
    pass, or 3xTF32 (small*big + big*small + big*big, f32 sums)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _k4_k5_tc(q, k, v, mask, dout, lse, delta, passes):
    """K4's (out, lse) and K5's dQ with every product (S = Q K^T, P V,
    dP = dO V^T, dS K) emulated as the kernels form them."""
    scale = ka._scale(q.shape[1])
    s = torch.where(mask[None] > 0, _mm(q, k.T, passes) * scale, -1e30)
    m = s.max(dim=1, keepdim=True).values
    p = torch.exp(s - m)
    l_fin = p.sum(dim=1, keepdim=True).clamp_min(1e-30)
    any_valid = m > -0.5e30
    out = torch.where(any_valid, _mm(p, v, passes) / l_fin, 0.0)
    lse_tc = torch.where(any_valid, m + torch.log(l_fin), 0.0)[:, 0]
    p_b = torch.exp(s - lse[:, None])
    ds = p_b * (_mm(dout, v.T, passes) - delta[:, None])
    return out, lse_tc, _mm(ds, k, passes) * scale


@pytest.mark.parametrize("case", ["train", "bg_stm", "bg_all"])
def test_3xtf32_products_hold_the_card_check(case):
    """K4's and K5's products on the tensor cores: with the 3xTF32 split
    every output holds the card's check |d| <= 1e-5 + 1e-4 |t| against
    the f32 plain versions, at the training shape (Lq 64, Lk 128, dk 128,
    dv 512, every key valid) and at bg's shape cut to Lq 240 (an 11-slot
    bank, the STM mask or every key valid). The error one TF32 pass would
    give is printed (`-s`), not asserted: it is why the kernels take three
    passes."""
    lq, slots = {"train": (64, 2), "bg_stm": (240, 11),
                 "bg_all": (240, 11)}[case]
    lk = lq * slots
    rng = np.random.RandomState(9)
    q, k, v, dout = (tt(rng.randn(*s).astype(np.float32)) for s in (
        (lq, DK), (lk, DK), (lk, DV), (lq, DV)))
    mask = torch.ones(lk)
    if case == "bg_stm":
        mask[:-lq] = 0.0
    out, lse = ka.attention_plain(q, k, v, mask)
    delta = (dout * out).sum(dim=1)
    want = (out, lse, ka.attention_bwd_dq_plain(q, k, v, mask, dout, lse,
                                                delta))
    worst = {}
    for passes in (3, 1):
        got = _k4_k5_tc(q, k, v, mask, dout, lse, delta, passes)
        worst[passes] = [
            (float((g - w).abs().max()),
             float(((g - w).abs() / (1e-5 + 1e-4 * w.abs())).max()))
            for g, w in zip(got, want)]
    print(f"\n3xTF32 vs 1xTF32 at {case} (Lq {lq}, Lk {lk}): (max |d|, "
          f"max |d| / (1e-5 + 1e-4 |t|)) for K4 out, K4 lse, K5 dQ: "
          f"3 passes {worst[3]}; 1 pass {worst[1]}")
    for what, (_, ratio) in zip(("out", "lse", "dQ"), worst[3]):
        assert ratio <= 1.0, (case, what, worst[3])


def _k6_tc(q, k, v, mask, dout, lse, delta, passes):
    """K6's dK and dV as `csrc/attention.cu:attn_bwd_dkv_kernel` forms
    them: S and dV = P^T dO in f32 on the FMA units (plain f32 products
    here), and on the tensor cores, per 64-query tile, dP^T as the f32 sum
    over 128-column chunks of V_c dO_c^T (each chunk's product a fresh
    accumulator) and the tile's dK = dS^T Q, a fresh accumulator added to
    the running sum in f32."""
    scale = ka._scale(q.shape[1])
    grad_k = torch.zeros(k.shape)
    s = torch.where(mask[:, None] > 0, (k @ q.T) * scale, -1e30)
    pt = torch.exp(s - lse[None])
    for q0 in range(0, q.shape[0], 64):
        qt, dot = q[q0:q0 + 64], dout[q0:q0 + 64]
        dpt = torch.zeros(k.shape[0], qt.shape[0])
        for c0 in range(0, v.shape[1], 128):
            dpt = dpt + _mm(v[:, c0:c0 + 128], dot[:, c0:c0 + 128].T,
                            passes)
        dst = pt[:, q0:q0 + 64] * (dpt - delta[None, q0:q0 + 64])
        grad_k = grad_k + _mm(dst, qt, passes)
    return grad_k * scale, pt @ dout


@pytest.mark.parametrize("case", ["train", "bg_stm", "bg_all"])
def test_3xtf32_k6_products_hold_the_card_check(case):
    """K6's tensor-core products (dP^T = V dO^T in 128-column chunks and
    dS^T Q per 64-query tile, each into a fresh accumulator): with the
    3xTF32 split dK and dV hold the card's check |d| <= 1e-5 + 1e-4 |t|
    against the f32 plain version, at the shapes of
    `test_3xtf32_products_hold_the_card_check`; masked keys' rows are
    exactly 0. The error of one TF32 pass is printed (`-s`)."""
    lq, slots = {"train": (64, 2), "bg_stm": (240, 11),
                 "bg_all": (240, 11)}[case]
    lk = lq * slots
    rng = np.random.RandomState(10)
    q, k, v, dout = (tt(rng.randn(*s).astype(np.float32)) for s in (
        (lq, DK), (lk, DK), (lk, DV), (lq, DV)))
    mask = torch.ones(lk)
    if case == "bg_stm":
        mask[:-lq] = 0.0
    out, lse = ka.attention_plain(q, k, v, mask)
    delta = (dout * out).sum(dim=1)
    want = ka.attention_bwd_dkv_plain(q, k, v, mask, dout, lse, delta)
    worst = {}
    for passes in (3, 1):
        got = _k6_tc(q, k, v, mask, dout, lse, delta, passes)
        worst[passes] = [
            (float((g - w).abs().max()),
             float(((g - w).abs() / (1e-5 + 1e-4 * w.abs())).max()))
            for g, w in zip(got, want)]
        if passes == 3:
            dead = mask <= 0
            assert not got[0][dead].any() and not got[1][dead].any()
    print(f"\nK6 3xTF32 vs 1xTF32 at {case} (Lq {lq}, Lk {lk}): (max |d|, "
          f"max |d| / (1e-5 + 1e-4 |t|)) for dK, dV: 3 passes {worst[3]}; "
          f"1 pass {worst[1]}")
    for what, (_, ratio) in zip(("dK", "dV"), worst[3]):
        assert ratio <= 1.0, (case, what, worst[3])
