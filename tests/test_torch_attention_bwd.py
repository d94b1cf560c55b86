"""The backward of the port's STM memory read against the JAX package.

`attention_bwd_plain` (the plain version of K5 and K6) against `jax.vjp`
of the Pallas `masked_memory_attention` with its flash-backward custom VJP
in interpret mode, as `tests/test_pallas_attention.py` runs it: a random
mask at Lq 150 x Lk 300, the STM mask (bank empty, the last frame valid),
one valid key, no valid key, and the batched (vmap) read, per item and as
one batched call. Tolerance rtol 1e-4, atol 1e-5 (f32 sums in another
order); a masked key's dK and dV must be exactly 0. Then
`MaskedMemoryAttention` through `gradcheck` in float64, the port's
`memory_read` gradients against the JAX einsum read's, and K5's choice of
key splits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import nn_, tt
from video_unscreen_tpu.models.stm import memory_read as j_memory_read
from video_unscreen_tpu.ops.pallas.attention import masked_memory_attention
from video_unscreen_tpu_torch.models.stm import memory_read
from video_unscreen_tpu_torch.ops.kernels import attention as ka

LQ, LK, DK, DV = 150, 300, 128, 128


def _mask(name, lk, rng):
    m = np.zeros(lk, np.float32)
    if name == "random":
        m = (rng.rand(lk) > 0.3).astype(np.float32)
    elif name == "stm":
        m[-LQ:] = 1.0
    elif name == "one":
        m[217] = 1.0
    return m


def _jax_grads(q, k, v, mask, g):
    """(dq, dk, dv) from the Pallas custom VJP, interpret mode."""
    _, vjp = jax.vjp(lambda a, b, c: masked_memory_attention(
        a, b, c, jnp.asarray(mask), interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(q, k, v, mask, g):
    q, k, v, mask, g = (tt(a) for a in (q, k, v, mask, g))
    out, lse = ka.attention_plain(q, k, v, mask)
    return ka.attention_bwd_plain(q, k, v, mask, out, lse, g)


@pytest.mark.parametrize("mask_name", ["random", "stm", "one", "none"])
def test_plain_backward_matches_pallas_vjp(mask_name):
    rng = np.random.RandomState(3)
    q, k, v, g = (rng.randn(*s).astype(np.float32)
                  for s in ((LQ, DK), (LK, DK), (LK, DV), (LQ, DV)))
    mask = _mask(mask_name, LK, rng)
    want = _jax_grads(q, k, v, mask, g)
    got = _port_grads(q, k, v, mask, g)
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(nn_(t), w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{mask_name} {name}")
    dead = mask == 0
    assert not nn_(got[1])[dead].any() and not nn_(got[2])[dead].any()
    if mask_name == "none":
        assert not any(nn_(t).any() for t in got)


def test_plain_backward_matches_pallas_vjp_batched():
    """The vmapped read of the JAX STM (b 2, one row all valid, one with
    half the keys masked) against the port's per-item backward."""
    rng = np.random.RandomState(4)
    b, lq, lk = 2, 130, 140
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((b, lq, DK), (b, lk, DK), (b, lk, DV)))
    g = rng.randn(b, lq, DV).astype(np.float32)
    mask = np.ones((b, lk), np.float32)
    mask[1, ::2] = 0.0

    def fn(a, b_, c, m):
        return masked_memory_attention(a, b_, c, m, interpret=True)

    _, vjp = jax.vjp(lambda a, b_, c: jax.vmap(fn)(a, b_, c,
                                                  jnp.asarray(mask)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    for i in range(b):
        got = _port_grads(q[i], k[i], v[i], mask[i], g[i])
        for w, t in zip(want, got):
            np.testing.assert_allclose(nn_(t), w[i], rtol=1e-4, atol=1e-5)
        dead = mask[i] == 0
        assert not nn_(got[1])[dead].any() and not nn_(got[2])[dead].any()


@pytest.mark.parametrize("mask_name", ["random", "all", "none"])
def test_autograd_read_gradcheck(mask_name):
    """MaskedMemoryAttention's analytic backward (the plain K5/K6 math)
    against finite differences of its forward, float64; the mask gets no
    gradient."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(*s, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for s in ((6, 8), (10, 8), (10, 12)))
    mask = {"random": (torch.rand(10, generator=gen) > 0.4).double(),
            "all": torch.ones(10, dtype=torch.float64),
            "none": torch.zeros(10, dtype=torch.float64)}[mask_name]
    assert torch.autograd.gradcheck(
        lambda a, b, c: ka.MaskedMemoryAttention.apply(a, b, c, mask),
        (q, k, v))
    m = mask.clone().requires_grad_()
    out = ka.MaskedMemoryAttention.apply(q, k, v, m)
    out.sum().backward()
    assert m.grad is None


def test_host_wrappers_take_the_plain_versions():
    """On the CPU the K5 and K6 wrappers and the autograd read run the
    plain versions (nothing is launched) and give what the plain backward
    gives; a shape the kernels refuse (dk 132 > 128) runs there too."""
    rng = np.random.RandomState(6)
    for dk in (DK, 132):
        q, k, v, g = (tt(rng.randn(*s).astype(np.float32))
                      for s in ((40, dk), (70, dk), (70, 36), (40, 36)))
        mask = tt((rng.rand(70) > 0.5).astype(np.float32))
        before = [(c.calls, c.launches) for c in (
            ka.ATTENTION, ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)]
        out, lse = ka.masked_memory_attention(q, k, v, mask)
        delta = (g * out).sum(dim=1)
        dq = ka.attention_bwd_dq(q, k, v, mask, g, lse, delta)
        dk_, dv_ = ka.attention_bwd_dkv(q, k, v, mask, g, lse, delta)
        want = ka.attention_bwd_plain(q, k, v, mask, out, lse, g)
        for got, w in zip((dq, dk_, dv_), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        grads = torch.autograd.grad(
            ka.MaskedMemoryAttention.apply(qr, kr, vr, mask), (qr, kr, vr),
            g)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
        assert [(c.calls, c.launches) for c in (
            ka.ATTENTION, ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)] \
            == before


@pytest.mark.parametrize("valid", [[[True, True]],
                                   [[False, True], [True, True]]])
def test_memory_read_gradients_match_jax(valid):
    """Gradients of the port's `memory_read` (through the autograd read)
    against `jax.grad` of the JAX `memory_read`'s einsum branch, for every
    input but the slot mask; rtol 1e-4, atol 1e-5."""
    rng = np.random.RandomState(7)
    valid = np.asarray(valid)
    b, t, hm, wm = valid.shape[0], valid.shape[1], 3, 4
    ins = [rng.randn(*s).astype(np.float32) for s in (
        (b, t, hm, wm, DK), (b, t, hm, wm, 512), (b, hm, wm, DK),
        (b, hm, wm, 512))]
    g = rng.randn(b, hm, wm, 1024).astype(np.float32)

    def loss(mk, mv, qk, qv):
        out = j_memory_read(mk, mv, jnp.asarray(valid), qk, qv,
                            use_pallas=False)
        return jnp.vdot(out, jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, ins))
    tins = [tt(a).requires_grad_() for a in ins]
    out = memory_read(tins[0], tins[1], torch.from_numpy(valid), tins[2],
                      tins[3])
    got = torch.autograd.grad((out * tt(g)).sum(), tins)
    for w, t_ in zip(want, got):
        np.testing.assert_allclose(nn_(t_), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_batched_plain_backward_matches_vmapped_pallas_vjp():
    """The batched plain backward (B 3, one call) against `jax.vjp` of the
    vmapped Pallas read: item 0's fully masked 64-key tiles lie at the
    start and the end, item 1's in the middle, item 2 has no valid key;
    the batched autograd read gives the same gradients."""
    rng = np.random.RandomState(10)
    b, lq, lk, dk, dv = 3, 70, 300, 64, 128
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((b, lq, dk), (b, lk, dk), (b, lk, dv)))
    g = rng.randn(b, lq, dv).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.float32)
    mask[0, :128] = 0.0
    mask[0, 4 * 64:] = 0.0
    mask[1, 2 * 64:3 * 64] = 0.0
    mask[2] = 0.0

    def fn(a, b_, c, m):
        return masked_memory_attention(a, b_, c, m, interpret=True)

    _, vjp = jax.vjp(lambda a, b_, c: jax.vmap(fn)(a, b_, c,
                                                  jnp.asarray(mask)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _port_grads(q, k, v, mask, g)
    tq, tk, tv = (tt(a).requires_grad_() for a in (q, k, v))
    auto = torch.autograd.grad(
        ka.MaskedMemoryAttention.apply(tq, tk, tv, tt(mask)), (tq, tk, tv),
        tt(g))
    for name, w, t, a in zip(("dq", "dk", "dv"), want, got, auto):
        assert t.shape == w.shape and a.shape == w.shape
        np.testing.assert_allclose(nn_(t), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(nn_(a), nn_(t), rtol=0, atol=0,
                                   err_msg=name)
    dead = mask == 0
    assert not nn_(got[1])[dead].any() and not nn_(got[2])[dead].any()
    assert not any(nn_(t)[2].any() for t in got)


@pytest.mark.parametrize("b,lq,lk,n_sm,want", [
    (1, 2040, 22440, 132, 8),   # bg's read: 32 query tiles x 8 = 256
    (8, 64, 128, 132, 2),       # training: capped at the 2 key tiles
    (1, 64, 22440, 132, 264),   # one query tile: 264 blocks
    (16, 2040, 22440, 132, 1),  # 512 blocks fill the card already
    (1, 37, 70, 132, 2),        # a ragged last key tile counts
])
def test_dq_splits(b, lq, lk, n_sm, want):
    """K5 splits its key range into as many shares as keep (query tiles
    x splits x B) blocks within two waves of the SMs, never into more
    splits than 64-key tiles, and at least one."""
    n = ka.dq_splits(b, lq, lk, n_sm)
    assert n == want
    blocks = b * -(-lq // 64)
    assert n == 1 or blocks * n <= 2 * n_sm
    assert n == -(-lk // 64) or blocks * (n + 1) > 2 * n_sm


@pytest.mark.parametrize("b,lk,dv,n_sm,want", [
    (1, 22440, 512, 132, (660, 1, 3)),  # bg: 42 key blocks in the last
                                        # wave, 3 blocks each -> 126
    (8, 128, 512, 132, (4, 4, 4)),      # training: 32 blocks x 4 -> 128
    (8, 512, 512, 132, (16, 1, 1)),     # --sizes 256: 128 blocks
    (1, 600, 512, 132, (19, 4, 4)),     # 19 key blocks: the 4 dv chunks
    (3, 600, 512, 132, (19, 2, 2)),     # 57 blocks x 2 -> 114
    (1, 70, 36, 132, (3, 1, 1)),        # one dv chunk: no group to share
    (1, 128, 384, 132, (4, 2, 2)),      # 3 dv chunks: groups of 1 and 2
    (1, 4500, 512, 132, (132, 1, 4)),   # 141 blocks: 9 over a wave -> 4
    (1, 8448, 512, 132, (264, 1, 1)),   # exactly two waves: no tail
    (2, 22440, 512, 132, (702, 1, 1)),  # a batch over a wave: no split
])
def test_dkv_grid(b, lk, dv, n_sm, want):
    """K6's grid: small reads share each 32-key block among a power of
    two of blocks (at most one per 128-column dV chunk) within one wave;
    a single read over a wave shares only its last wave's key blocks, as
    many blocks each as fill that wave; every key block is covered."""
    tail0, g_head, g_tail = got = ka.dkv_grid(b, lk, dv, n_sm)
    n_kb, chunks = -(-lk // 32), -(-dv // 128)
    assert got == want
    assert 0 <= tail0 <= n_kb
    assert 1 <= g_head <= chunks and 1 <= g_tail <= chunks
    blocks = b * (tail0 * g_head + (n_kb - tail0) * g_tail)
    if b * n_kb > n_sm:
        # the split adds no wave
        assert -(-blocks // n_sm) == -(-(b * n_kb) // n_sm)
    else:
        assert blocks <= n_sm
