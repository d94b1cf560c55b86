"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a card. This file imports neither
JAX nor the JAX package, so on the card's machine (no JAX there) it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

# imported by its own name: pytest puts tests/ on sys.path, and on a
# machine where another distribution installs a top-level `tests` package
# the name `tests.torch_port_util` does not resolve
from torch_port_util import (assert_equal, blob_mask, cuda, require_cuda,
                             soft_mask)
from video_unscreen_tpu_torch.ops.kernels import attention as ka
from video_unscreen_tpu_torch.ops.kernels import connected as kcc
from video_unscreen_tpu_torch.ops.kernels import morph as km
from video_unscreen_tpu_torch.ops.morphology import ellipse_offsets


def _dev(a):
    return torch.from_numpy(np.array(a, np.float32)).cuda()


def _chain_launches(k, iters):
    """Launches of a K2 chain: csrc/morph.cu carries at most 16 halo cells,
    so 16 // r iterations, per launch."""
    r = max(max(abs(dy), abs(dx)) for dy, dx in ellipse_offsets(k))
    return 1 if r == 0 else max(1, -(-iters // (16 // r)))


@cuda
@pytest.mark.parametrize("k,iters", [(3, 2), (3, 5), (3, 40), (4, 2),
                                     (5, 3), (7, 10), (1, 3)])
@pytest.mark.parametrize("shape", [(544, 960), (37, 150)])
def test_morph_kernel(k, iters, shape):
    require_cuda()
    x = _dev(soft_mask(*shape, seed=k))
    for dil in (True, False):
        before = (km.MORPH.calls, km.MORPH.launches)
        got = km.morph(x, ellipse_offsets(k), iters, dil)
        assert (km.MORPH.calls, km.MORPH.launches) == (
            before[0] + 1, before[1] + _chain_launches(k, iters))
        assert_equal(got, km.morph_plain(x, ellipse_offsets(k), iters, dil))


@cuda
@pytest.mark.parametrize("k,iters", [(3, 5), (3, 3), (3, 20), (5, 4)])
@pytest.mark.parametrize("shape", [(544, 960), (40, 130), (16, 140)])
def test_trimap_kernel(k, iters, shape):
    require_cuda()
    x = _dev(soft_mask(*shape, seed=iters))
    before = km.TRIMAP.launches
    assert_equal(km.trimap(x, ellipse_offsets(k), iters),
                 km.trimap_plain(x, ellipse_offsets(k), iters))
    # one fused launch, after the chains' first iterations as K2 launches
    r = max(max(abs(dy), abs(dx)) for dy, dx in ellipse_offsets(k))
    head = max(0, iters - 16 // r)
    assert km.TRIMAP.launches == before + 1 + 2 * (
        _chain_launches(k, head) if head else 0)
    full = _dev(np.full(shape, 255.0))  # touches every border
    assert_equal(km.trimap(full, ellipse_offsets(k), iters),
                 km.trimap_plain(full, ellipse_offsets(k), iters))


@cuda
@pytest.mark.parametrize("seed,p", [(0, 0.05), (1, 0.3), (2, 0.45),
                                    (3, 0.6), (4, 1.0)])
@pytest.mark.parametrize("shape", [(272, 480), (33, 70), (1, 1000)])
def test_flood_kernel(seed, p, shape):
    require_cuda()
    rng = np.random.RandomState(seed)
    m = _dev((rng.rand(*shape) < p) * 255.0)
    before = kcc.FLOOD.launches
    for g, w in zip(kcc.connected_components_compact(m), kcc.cc_plain(m)):
        assert_equal(g, w)
    assert kcc.FLOOD.launches == before + 7


@cuda
def test_flood_kernel_on_blobs():
    require_cuda()
    m = _dev(blob_mask(272, 480, seed=1, speckle=0.02))
    for g, w in zip(kcc.connected_components_compact(m), kcc.cc_plain(m)):
        assert_equal(g, w)


@cuda
@pytest.mark.parametrize("dil", [True, False])
def test_morph_kernel_even_se_full_res(dil):
    """bg mode's dilate(., 4, 2) at 1080x1920: the 4x4 ellipse is anchored
    at (2, 2) and covers its top-left 3x3 cross, so its offsets run from
    -2 to 0 (asymmetric)."""
    require_cuda()
    offs = ellipse_offsets(4)
    assert min(min(o) for o in offs) == -2 and max(max(o) for o in offs) == 0
    x = _dev(soft_mask(1080, 1920, seed=4))
    before = km.MORPH.launches
    assert_equal(km.morph(x, offs, 2, dil), km.morph_plain(x, offs, 2, dil))
    assert km.MORPH.launches == before + 1


@cuda
@pytest.mark.parametrize("case", ["blobs", "random"])
def test_flood_kernel_full_res(case):
    """Object removal's labeling at bg mode's full 1080x1920 (2,025 count
    blocks feed the one-block scan)."""
    require_cuda()
    if case == "blobs":
        m = _dev(blob_mask(1080, 1920, seed=2, speckle=0.01))
    else:
        rng = np.random.RandomState(5)
        m = _dev((rng.rand(1080, 1920) < 0.45) * 255.0)
    before = kcc.FLOOD.launches
    for g, w in zip(kcc.connected_components_compact(m), kcc.cc_plain(m)):
        assert_equal(g, w)
    assert kcc.FLOOD.launches == before + 7


def _attention_case(lq, lk, dk, dv, mask_name, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.zeros(lk, np.float32)
    if mask_name == "stm":             # empty bank: only the last frame
        mask[-lq:] = 1.0
    elif mask_name == "all":
        mask[:] = 1.0
    elif mask_name == "all_but_one":
        mask[lk // 3] = 1.0
    elif mask_name == "random":
        mask = (rng.rand(lk) > 0.5).astype(np.float32)
    return [_dev(a) for a in (rng.randn(lq, dk), rng.randn(lk, dk),
                              rng.randn(lk, dv), mask)]


@cuda
@pytest.mark.parametrize("mask_name", ["stm", "all", "all_but_one", "none",
                                       "random"])
@pytest.mark.parametrize("shape", [(2040, 22440, 128, 512),
                                   (200, 600, 128, 512), (37, 70, 64, 36)])
def test_attention_kernel(shape, mask_name):
    """K4 against its plain version: the bg path's shape (Lq 2040 queries
    at 544x960 / 16, an 11-slot bank) and ragged ones; rtol 1e-4, atol
    1e-5 on out and LSE (f32 sums in another order)."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _attention_case(*shape, mask_name)
    before = (ka.ATTENTION.calls, ka.ATTENTION.launches)
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    assert (ka.ATTENTION.calls, ka.ATTENTION.launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want_lse = ka.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    for got, want in ((out, want_out), (lse, want_lse)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if mask_name == "none":
        assert not out.any() and not lse.any()


def _dead_keys_are_zero(mask, *grads):
    """dK and dV rows of masked keys are exactly 0."""
    dead = mask <= 0
    for g in grads:
        assert not g[dead].any()


@cuda
@pytest.mark.parametrize("mask_name", ["stm", "all", "all_but_one", "none",
                                       "random"])
@pytest.mark.parametrize("shape", [(2040, 22440, 128, 512),
                                   (200, 600, 128, 512), (37, 70, 64, 36)])
def test_attention_bwd_kernels(shape, mask_name):
    """K5 (dQ) and K6 (dK, dV) against the plain backward, from the plain
    forward's out and LSE and a seeded dO: the bg path's shape and ragged
    ones; rtol 1e-4, atol 1e-5 (f32 sums in another order; see below for
    the one-valid-key case); masked keys' dK and dV exactly 0, and every
    gradient exactly 0 with no valid key."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _attention_case(*shape, mask_name)
    out, lse = ka.attention_plain(q, k, v, mask)
    dout = _dev(np.random.RandomState(1).randn(shape[0], shape[3]))
    delta = (dout * out).sum(dim=1)
    before = [(c.calls, c.launches)
              for c in (ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)]
    dq = ka.attention_bwd_dq(q, k, v, mask, dout, lse, delta)
    dk, dv = ka.attention_bwd_dkv(q, k, v, mask, dout, lse, delta)
    assert [(c.calls, c.launches)
            for c in (ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)] == [
        (n + 1, m + 1) for n, m in before]
    want = ka.attention_bwd_plain(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    # With one valid key the softmax is constant: the exact dQ and dK are
    # 0, and both versions return the rounding noise of dS = P (dP -
    # delta), a difference of two sums of dv products that agree to f32
    # rounding of their own size; that noise is held to 1e-5 of |dP|.
    noise = 1.0
    if mask_name == "all_but_one":
        noise = max(1.0, float((dout @ v[mask > 0].T).abs().max()))
    for got, w, atol in zip((dq, dk, dv), want, (1e-5 * noise,) * 2
                            + (1e-5,)):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=atol)
    _dead_keys_are_zero(mask, dk, dv)
    if mask_name == "none":
        assert not dq.any() and not dk.any() and not dv.any()


@cuda
def test_autograd_read_launches_the_kernels():
    """MaskedMemoryAttention on the card: K4 forward, K5 and K6 backward,
    one launch each, gradients as the plain backward's."""
    require_cuda()
    q, k, v, mask = _attention_case(64, 128, 128, 512, "random")
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dout = _dev(np.random.RandomState(2).randn(64, 512))
    before = [(c.calls, c.launches) for c in (
        ka.ATTENTION, ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)]
    out = ka.MaskedMemoryAttention.apply(q, k, v, mask)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert [(c.calls, c.launches) for c in (
        ka.ATTENTION, ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)] == [
        (n + 1, m + 1) for n, m in before]
    with torch.no_grad():
        o, lse = ka.attention_plain(q, k, v, mask)
        want = ka.attention_bwd_plain(q, k, v, mask, o, lse, dout)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)


@cuda
def test_wrappers_reject_bad_input():
    require_cuda()
    x = _dev(soft_mask(32, 64))
    with pytest.raises(ValueError):
        km.morph(x.t(), ellipse_offsets(3), 2, True)       # not contiguous
    with pytest.raises(ValueError):
        km.trimap(x.double(), ellipse_offsets(3), 2)        # not float32
    with pytest.raises(ValueError):
        kcc.connected_components_compact(x[None])           # not 2-D
    q, k, v, mask = _attention_case(64, 128, 128, 512, "all")
    with pytest.raises(ValueError):
        ka.masked_memory_attention(q, k, v[:, 1:], mask)    # dv not 4n
    with pytest.raises(ValueError):
        ka.masked_memory_attention(q, k.t(), v, mask)       # k not (Lk, dk)
    with pytest.raises(ValueError):
        ka.masked_memory_attention(q[:, :2].contiguous(), k[:, :2]
                                   .contiguous(), v, mask)  # dk not 4n
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    dout = torch.ones_like(out)
    delta = (dout * out).sum(dim=1)
    for fn in (ka.attention_bwd_dq, ka.attention_bwd_dkv):
        with pytest.raises(ValueError):
            fn(q, k, v, mask, dout[:, 4:].contiguous(), lse, delta)  # dout
        with pytest.raises(ValueError):
            fn(q, k, v, mask, dout, lse[1:], delta)            # lse not (Lq,)
    # the autograd read refuses what K4 refuses (dk > 128), on the card,
    # and never sends it to the plain version
    wide = _attention_case(64, 128, 132, 512, "all")
    with pytest.raises(ValueError):
        ka.MaskedMemoryAttention.apply(*wide)


@cuda
def test_green_pipeline_card_matches_host():
    require_cuda()
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.pipeline.fused_green import \
        FusedGreenPipeline
    cfg = load_config("configs/green.json")
    cfg["binseg"] = {"type": "chroma"}
    rng = np.random.RandomState(0)
    frames = []
    yy, xx = np.mgrid[0:96, 0:128]
    for t in range(3):
        img = np.empty((96, 128, 3), np.float32)
        img[...] = (40, 190, 50)
        img[((yy - 48) ** 2 / 900 + (xx - 50 - 4 * t) ** 2 / 400) < 1] = (
            150, 60, 170)
        frames.append((img + rng.randn(96, 128, 3) * 5).clip(0, 255)
                      .astype(np.uint8))
    out = {dev: FusedGreenPipeline(cfg, (96, 128), work_long_side=128,
                                   device=dev).run(frames)
           for dev in ("cuda", "cpu")}
    d = np.abs(out["cuda"][0].astype(int) - out["cpu"][0].astype(int))
    assert d.max() <= 4 and (d > 1).mean() < 1e-3, (d.max(), (d > 1).mean())


@cuda
def test_bg_pipeline_card_matches_host():
    """bg mode (chroma seed, shipped STM and matting weights) at 96x128 on
    the card and on the host: uint8 alphas within the JAX suite's bound."""
    require_cuda()
    from video_unscreen_tpu_torch.config import load_config
    from video_unscreen_tpu_torch.ops.kernels import reset_counts, counts
    from video_unscreen_tpu_torch.pipeline import bg
    cfg = load_config("configs/bg.json")
    cfg["binseg"] = {"type": "chroma", "input_long_side": 128}
    for key in ("stm", "trimap", "vmatting"):
        cfg[key]["input_long_side"] = 128
    rng = np.random.RandomState(0)
    frames = []
    yy, xx = np.mgrid[0:96, 0:128]
    for t in range(3):
        img = np.empty((96, 128, 3), np.float32)
        img[...] = (40, 190, 50)
        img[((yy - 48) ** 2 / 900 + (xx - 50 - 4 * t) ** 2 / 400) < 1] = (
            150, 60, 170)
        frames.append((img + rng.randn(96, 128, 3) * 5).clip(0, 255)
                      .astype(np.uint8))
    reset_counts()
    card = bg.run(cfg, frames, device="cuda")
    launched = counts()
    host = bg.run(cfg, frames, device="cpu")
    assert all(n > 0 for name, (_, n) in launched.items()
               if not name.startswith("attention_bwd")), launched
    assert launched["attention"] == (2, 2), launched
    # inference runs no backward
    assert launched["attention_bwd_dq"] == launched["attention_bwd_dkv"] \
        == (0, 0), launched
    for a, b in zip(card["alphas"], host["alphas"]):
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 4 and (d > 1).mean() < 1e-3, (d.max(),
                                                         (d > 1).mean())
