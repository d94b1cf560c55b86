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
from video_unscreen_tpu_torch.ops.kernels.cc_masks import HARD_MASKS, hard_mask
from video_unscreen_tpu_torch.ops.kernels import morph as km
from video_unscreen_tpu_torch.ops.kernels.morph_cases import (
    MORPH_CALLS, MORPH_HARD_MASKS, morph_hard_mask, se_offsets)
from video_unscreen_tpu_torch.ops.morphology import ellipse_offsets


def _dev(a):
    return torch.from_numpy(np.array(a, np.float32)).cuda()


# K3's launches a call: local merge, edge merge, compress and rank, finish
FLOOD_LAUNCHES = 4


# The most iterations one launch carries, by ellipse size, for K2 and K1:
# the halos must leave an output tile of 32 of the window's 128 columns
# and 16 of its rows (K2 blocks up to 32 warps, K1 blocks up to 16, 6 rows
# a thread past 20 rows of halo). k = 1 has no neighbours: no limit.
K2_PER_LAUNCH = {3: 48, 4: 48, 5: 24, 7: 16}
K1_PER_LAUNCH = {3: 40, 4: 40, 5: 17, 7: 11}


def _chain_launches(k, iters):
    """Launches of a K2 chain: one while it fits a launch, else
    near-equal launches."""
    if k not in K2_PER_LAUNCH:
        return 1
    return -(-max(iters, 1) // K2_PER_LAUNCH[k])


def _trimap_launches(k, iters):
    """Launches of a K1 call: one fused launch, after a chain too long for
    it has run its head as two K2 chains (dilate, erode)."""
    head = max(0, iters - K1_PER_LAUNCH.get(k, iters))
    return 1 + (2 * _chain_launches(k, head) if head else 0)


@cuda
@pytest.mark.parametrize("k,iters", [(3, 2), (3, 5), (3, 40), (4, 2),
                                     (5, 3), (7, 10), (1, 3), (3, 60),
                                     (7, 20)])
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
@pytest.mark.parametrize("k,iters", [(3, 5), (3, 3), (3, 20), (5, 4),
                                     (3, 60)])
@pytest.mark.parametrize("shape", [(544, 960), (40, 130), (16, 140)])
def test_trimap_kernel(k, iters, shape):
    require_cuda()
    x = _dev(soft_mask(*shape, seed=iters))
    before = km.TRIMAP.launches
    assert_equal(km.trimap(x, ellipse_offsets(k), iters),
                 km.trimap_plain(x, ellipse_offsets(k), iters))
    assert km.TRIMAP.launches == before + _trimap_launches(k, iters)
    full = _dev(np.full(shape, 255.0))  # touches every border
    assert_equal(km.trimap(full, ellipse_offsets(k), iters),
                 km.trimap_plain(full, ellipse_offsets(k), iters))


def _hold_call(kernel, x, offs, iters):
    """K1 or K2 on x against its plain version (K2 in both directions),
    one launch a call."""
    counter = km.TRIMAP if kernel == "trimap" else km.MORPH
    for dil in ((None,) if kernel == "trimap" else (True, False)):
        before = (counter.calls, counter.launches)
        if kernel == "trimap":
            got, want = (km.trimap(x, offs, iters),
                         km.trimap_plain(x, offs, iters))
        else:
            got, want = (km.morph(x, offs, iters, dil),
                         km.morph_plain(x, offs, iters, dil))
        assert (counter.calls, counter.launches) == (before[0] + 1,
                                                     before[1] + 1)
        assert_equal(got, want)


@cuda
@pytest.mark.parametrize("kernel,caller,shape,se,iters,batch", MORPH_CALLS)
def test_morph_kernels_on_paths(kernel, caller, shape, se, iters, batch):
    """Every K1 and K2 call the green, bg, fused bg, bg_offline,
    background-model and training paths make (`morph_cases.MORPH_CALLS`),
    bit-exact and one launch: on one plane and on the call's batch (the
    most planes a path gives it at once, at least run_segmented's S)."""
    require_cuda()
    offs = se_offsets(se)
    _hold_call(kernel, _dev(soft_mask(*shape, seed=iters)), offs, iters)
    batch = np.stack([soft_mask(*shape, seed=iters + j)
                      for j in range(batch - 2)]
                     + [morph_hard_mask("edges", *shape),
                        morph_hard_mask("checkerboard", *shape)])
    _hold_call(kernel, _dev(batch), offs, iters)


@cuda
@pytest.mark.parametrize("case", MORPH_HARD_MASKS)
@pytest.mark.parametrize("shape", [(544, 960), (37, 150), (40, 130),
                                   (16, 140)])
def test_morph_kernels_hard_masks(case, shape):
    """All 255, all 0, a hot pixel at each corner, a line along each edge
    and a checkerboard, at the green work size and at widths that are not
    multiples of 4 or of a tile: the cross (k3 it2, it40), the 4x4
    ellipse and K1."""
    require_cuda()
    x = _dev(morph_hard_mask(case, *shape))
    for kernel, se, iters in (("morph", "ellipse3", 2),
                              ("morph", "ellipse3", 40),
                              ("morph", "ellipse4", 2),
                              ("trimap", "ellipse3", 5)):
        _hold_call(kernel, x, se_offsets(se), iters)


@cuda
@pytest.mark.parametrize("k,iters", [(3, 2), (4, 2), (3, 40), (7, 3)])
@pytest.mark.parametrize("shape", [(544, 960), (37, 150)])
def test_morph_kernels_batched(k, iters, shape):
    """A batch of 3 different masks in one launch of K2 (each direction)
    and of K1: each item as the plain version of that item alone."""
    require_cuda()
    x = _dev(np.stack([soft_mask(*shape, seed=iters),
                       morph_hard_mask("edges", *shape),
                       morph_hard_mask("checkerboard", *shape)]))
    offs = ellipse_offsets(k)
    want_launches = (_chain_launches(k, iters), _trimap_launches(k, iters))
    for kernel, counter, n in (("morph", km.MORPH, want_launches[0]),
                               ("trimap", km.TRIMAP, want_launches[1])):
        for dil in ((True, False) if kernel == "morph" else (None,)):
            before = counter.launches
            got = (km.morph(x, offs, iters, dil) if kernel == "morph"
                   else km.trimap(x, offs, iters))
            assert counter.launches == before + n
            assert got.shape == x.shape
            for i in range(3):
                want = (km.morph_plain(x[i], offs, iters, dil)
                        if kernel == "morph"
                        else km.trimap_plain(x[i], offs, iters))
                assert_equal(got[i], want)


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
    assert kcc.FLOOD.launches == before + FLOOD_LAUNCHES


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
    """Object removal's labeling at bg mode's full 1080x1920 (2,025
    blocks of the rank pass chain their look-back scan)."""
    require_cuda()
    if case == "blobs":
        m = _dev(blob_mask(1080, 1920, seed=2, speckle=0.01))
    else:
        rng = np.random.RandomState(5)
        m = _dev((rng.rand(1080, 1920) < 0.45) * 255.0)
    before = kcc.FLOOD.launches
    for g, w in zip(kcc.connected_components_compact(m), kcc.cc_plain(m)):
        assert_equal(g, w)
    assert kcc.FLOOD.launches == before + FLOOD_LAUNCHES


@cuda
@pytest.mark.parametrize("case", HARD_MASKS)
def test_flood_kernel_hard_masks_full_res(case):
    """The masks that break label schemes, at 1080x1920: a checkerboard
    (only diagonal contacts: every pixel its own component), a one-pixel
    snake that crosses every 32-pixel tile edge, the full and the empty
    mask."""
    require_cuda()
    m = _dev(hard_mask(case, 1080, 1920))
    before = kcc.FLOOD.launches
    for g, w in zip(kcc.connected_components_compact(m), kcc.cc_plain(m)):
        assert_equal(g, w)
    assert kcc.FLOOD.launches == before + FLOOD_LAUNCHES


def _disk_pair(h, w, seed=0):
    """A soft GT of 300 small disks and a prediction shifted by a pixel and
    noised, 0..255 float32 with integer values: CONN's intersections are
    unions of small components, so the plain labels settle in a few dozen
    steps even on the host."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    gt = np.zeros((h, w), np.float32)
    for _ in range(300):
        cy, cx, r = rng.randint(h), rng.randint(w), rng.uniform(4, 14)
        d = np.sqrt((yy[max(cy - 16, 0):cy + 16, max(cx - 16, 0):cx + 16]
                     - cy) ** 2
                    + (xx[max(cy - 16, 0):cy + 16, max(cx - 16, 0):cx + 16]
                       - cx) ** 2)
        sl = gt[max(cy - 16, 0):cy + 16, max(cx - 16, 0):cx + 16]
        np.maximum(sl, np.clip((r - d) * 64.0, 0, 255), out=sl)
    pred = np.roll(gt, (1, 1), (0, 1)) + rng.randn(h, w).astype(
        np.float32) * 10.0
    return np.round(gt), np.clip(np.round(pred), 0, 255)


@cuda
def test_flood_kernel_on_conn_intersections():
    """K3 at the evaluation's call: CONN's 11 thresholded intersections of
    a 1080x1920 pair, bit-exact against the plain labels, 4 launches a
    call."""
    require_cuda()
    from video_unscreen_tpu_torch.ops.metrics import thresholds
    gt, pred = (_dev(a) / 255.0 for a in _disk_pair(1080, 1920))
    for t in thresholds():
        m = ((gt >= float(t)) & (pred >= float(t))).to(torch.float32)
        before = kcc.FLOOD.launches
        for g, w in zip(kcc.connected_components_compact(m),
                        kcc.cc_plain(m)):
            assert_equal(g, w, f"threshold {t}")
        assert kcc.FLOOD.launches == before + FLOOD_LAUNCHES


@cuda
def test_metrics_card_against_host():
    """The evaluation's device chain (`pipeline/evaluate.py:score_pair`,
    and `roi_sad`) on a 1080x1920 pair, card against host: every score
    within 1e-4 relative (sums in another order; TF32 off); K3 11 calls
    and K2 2, one launch each for K2."""
    require_cuda()
    from video_unscreen_tpu_torch.ops import kernels
    from video_unscreen_tpu_torch.ops.metrics import roi_sad
    from video_unscreen_tpu_torch.pipeline.evaluate import score_pair
    from video_unscreen_tpu_torch.utils.device import resolve_device
    resolve_device("cuda")   # TF32 off, as the entry points set it
    gt, pred = _disk_pair(1080, 1920, seed=1)
    host = torch.cat([score_pair(torch.from_numpy(gt), torch.from_numpy(pred)),
                      roi_sad(torch.from_numpy(gt),
                              torch.from_numpy(pred))[None]])
    kernels.reset_counts()
    card = torch.cat([score_pair(_dev(gt), _dev(pred)),
                      roi_sad(_dev(gt), _dev(pred))[None]]).cpu()
    counts = kernels.counts()
    assert counts["flood"] == (11, 11 * FLOOD_LAUNCHES)
    assert counts["morph"] == (2, 2)
    rel = (card.double() - host.double()).abs() / host.double().abs().clamp_min(
        1e-6)
    assert bool((rel <= 1e-4).all()), (card.tolist(), host.tolist())


MASKS = ["stm", "all", "all_but_one", "none", "random", "mid_tile",
         "last_key"]


def _mask(name, lq, lk, rng):
    mask = np.zeros(lk, np.float32)
    if name == "stm":                  # empty bank: only the last frame
        mask[-lq:] = 1.0
    elif name == "all":
        mask[:] = 1.0
    elif name == "all_but_one":
        mask[lk // 3] = 1.0
    elif name == "random":
        mask = (rng.rand(lk) > 0.5).astype(np.float32)
    elif name == "mid_tile":           # one live 64-key tile in the middle
        mid = (-(-lk // 64)) // 2 * 64
        mask[mid:mid + 64] = 1.0
    elif name == "last_key":           # the only valid key is the last
        mask[-1] = 1.0
    return mask


def _attention_case(lq, lk, dk, dv, mask_name, seed=0):
    rng = np.random.RandomState(seed)
    mask = _mask(mask_name, lq, lk, rng)
    return [_dev(a) for a in (rng.randn(lq, dk), rng.randn(lk, dk),
                              rng.randn(lk, dv), mask)]


def _batched_case(b, lq, lk, dk, dv, seed=0):
    """q, k, v, dO drawn on the card, and item i's mask MASKS[i % 7]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(*s, generator=gen, device="cuda")
                     for s in ((b, lq, dk), (b, lk, dk), (b, lk, dv),
                               (b, lq, dv)))
    rng = np.random.RandomState(seed)
    names = [MASKS[i % len(MASKS)] for i in range(b)]
    mask = _dev(np.stack([_mask(n, lq, lk, rng) for n in names]))
    return q, k, v, mask, dout, names


def _dq_launches(b, lq, lk):
    """K5's launches for a call not handed the live-tile list: the list,
    the kernel, and the sum of the splits where there are several."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 + (ka.dq_splits(b, lq, lk, n_sm) > 1)


SHAPES = [(2040, 22440, 128, 512), (200, 600, 128, 512), (37, 70, 64, 36)]


@cuda
@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_kernel(shape, mask_name):
    """K4 against its plain version: the bg path's shape (Lq 2040 queries
    at 544x960 / 16, an 11-slot bank) and ragged ones; rtol 1e-4, atol
    1e-5 on out and LSE (f32 sums in another order, 3xTF32 products). One
    call is two launches: the live-tile list, then K4."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _attention_case(*shape, mask_name)
    before = (ka.ATTENTION.calls, ka.ATTENTION.launches)
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    assert (ka.ATTENTION.calls, ka.ATTENTION.launches) == (
        before[0] + 1, before[1] + 2)
    want_out, want_lse = ka.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    for got, want in ((out, want_out), (lse, want_lse)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if mask_name == "none":
        assert not out.any() and not lse.any()


@cuda
@pytest.mark.parametrize("bank_n", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 8])
def test_attention_kernel_fused_bg(b, bank_n):
    """K4 at the fused bg read: Lq 2040 over a ring bank of 2 slots plus
    the previous frame (Lk 3 x 2040 = 6120), the first `bank_n` slots and
    the last valid, on a batch of b segments in one call; against the
    plain version, rtol 1e-4, atol 1e-5."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    lq, slots = 2040, 3
    gen = torch.Generator(device="cuda").manual_seed(bank_n)
    q, k, v = (torch.randn(*s, generator=gen, device="cuda")
               for s in ((b, lq, 128), (b, slots * lq, 128),
                         (b, slots * lq, 512)))
    valid = torch.tensor([s < bank_n or s == slots - 1
                          for s in range(slots)], device="cuda")
    mask = valid.float().repeat_interleave(lq).expand(b, -1).contiguous()
    before = (ka.ATTENTION.calls, ka.ATTENTION.launches)
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    assert (ka.ATTENTION.calls, ka.ATTENTION.launches) == (
        before[0] + 1, before[1] + 2)
    want_out, want_lse = ka.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    for got, want in ((out, want_out), (lse, want_lse)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@cuda
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_kernel_batched(shape, b):
    """K4 on a batch in one call (one launch of the list, one of K4),
    item i with mask MASKS[i % 7], against the batched plain version;
    rtol 1e-4, atol 1e-5; the item with no valid key gets exactly 0."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask, _, names = _batched_case(b, *shape)
    before = (ka.ATTENTION.calls, ka.ATTENTION.launches)
    out, lse = ka.masked_memory_attention(q, k, v, mask)
    assert (ka.ATTENTION.calls, ka.ATTENTION.launches) == (
        before[0] + 1, before[1] + 2)
    assert out.shape == (b, shape[0], shape[3]) and lse.shape == (b,
                                                                  shape[0])
    want_out, want_lse = ka.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    for got, want in ((out, want_out), (lse, want_lse)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for i, name in enumerate(names):
        if name == "none":
            assert not out[i].any() and not lse[i].any()


@cuda
def test_live_key_tiles():
    """The list K4 and K5 walk: per item, the 64-key tiles holding a key
    > 0, in increasing order, and their count."""
    require_cuda()
    lq, lk = 2040, 22440
    rng = np.random.RandomState(3)
    masks = np.stack([_mask(n, lq, lk, rng) for n in MASKS]
                     + [(rng.rand(lk) > 0.999).astype(np.float32)])
    (tiles, n_live), launches = ka._live_key_tiles(_dev(masks))
    assert launches == 1
    tiles, n_live = tiles.cpu().numpy(), n_live.cpu().numpy()
    n_tiles = -(-lk // 64)
    assert tiles.shape == (len(masks), n_tiles)
    for i, m in enumerate(masks):
        padded = np.zeros(n_tiles * 64, np.float32)
        padded[:lk] = m
        want = np.flatnonzero((padded.reshape(n_tiles, 64) > 0).any(1))
        assert n_live[i] == len(want)
        np.testing.assert_array_equal(tiles[i, :len(want)], want)


def _dead_keys_are_zero(mask, *grads):
    """dK and dV rows of masked keys are exactly 0."""
    dead = mask <= 0
    for g in grads:
        assert not g[dead].any()


def _hold_bwd(got, want, mask_name, dout, v, mask):
    """dQ, dK, dV within rtol 1e-4, atol 1e-5 (f32 sums in another order,
    3xTF32 products). With one valid key the softmax is constant: the
    exact dQ and dK are 0, and both versions return the rounding noise of
    dS = P (dP - delta), a difference of two sums of dv products that
    agree to f32 rounding of their own size; that noise is held to 1e-5
    of |dP|."""
    noise = 1.0
    if mask_name in ("all_but_one", "last_key"):
        noise = max(1.0, float((dout @ v[mask > 0].T).abs().max()))
    for g, w, atol in zip(got, want, (1e-5 * noise,) * 2 + (1e-5,)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=atol)
    _dead_keys_are_zero(mask, *got[1:])
    if mask_name == "none":
        assert not any(g.any() for g in got)


@cuda
@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_bwd_kernels(shape, mask_name):
    """K5 (dQ) and K6 (dK, dV) against the plain backward, from the plain
    forward's out and LSE and a seeded dO: the bg path's shape and ragged
    ones (see `_hold_bwd`); masked keys' dK and dV exactly 0, and every
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
        (before[0][0] + 1, before[0][1] + _dq_launches(1, *shape[:2])),
        (before[1][0] + 1, before[1][1] + 1)]
    want = ka.attention_bwd_plain(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    _hold_bwd((dq, dk, dv), want, mask_name, dout, v, mask)


@cuda
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_bwd_kernels_batched(shape, b):
    """K5 and K6 on a batch in one call each, item i with mask MASKS[i %
    7], against the batched plain backward, each item held as
    `_hold_bwd` holds a single read."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask, dout, names = _batched_case(b, *shape)
    out, lse = ka.attention_plain(q, k, v, mask)
    delta = (dout * out).sum(dim=-1)
    before = [(c.calls, c.launches)
              for c in (ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)]
    dq = ka.attention_bwd_dq(q, k, v, mask, dout, lse, delta)
    dk, dv = ka.attention_bwd_dkv(q, k, v, mask, dout, lse, delta)
    assert [(c.calls, c.launches)
            for c in (ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)] == [
        (before[0][0] + 1, before[0][1] + _dq_launches(b, *shape[:2])),
        (before[1][0] + 1, before[1][1] + 1)]
    want = ka.attention_bwd_plain(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    for i, name in enumerate(names):
        _hold_bwd((dq[i], dk[i], dv[i]), [w[i] for w in want], name,
                  dout[i], v[i], mask[i])


@cuda
@pytest.mark.parametrize("mask_name", ["mid_tile", "last_key"])
def test_attention_bwd_dq_more_splits_than_live_tiles(mask_name):
    """One query tile over an 11-slot bank: K5 takes 264 key splits, and
    the mask leaves one live tile, so all splits but one have an empty
    share and write zeros into the sum."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (64, 22440, 128, 512)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert ka.dq_splits(1, 64, 22440, n_sm) > 1
    q, k, v, mask = _attention_case(*shape, mask_name)
    out, lse = ka.attention_plain(q, k, v, mask)
    dout = _dev(np.random.RandomState(1).randn(shape[0], shape[3]))
    delta = (dout * out).sum(dim=1)
    dq = ka.attention_bwd_dq(q, k, v, mask, dout, lse, delta)
    want = ka.attention_bwd_dq_plain(q, k, v, mask, dout, lse, delta)
    noise = 1.0
    if mask_name == "last_key":
        noise = max(1.0, float((dout @ v[mask > 0].T).abs().max()))
    torch.testing.assert_close(dq, want, rtol=1e-4, atol=1e-5 * noise)


@cuda
@pytest.mark.parametrize("mask_name", ["all", "stm"])
def test_attention_bwd_dq_is_deterministic(mask_name):
    """K5 sums its key splits in a fixed order (no atomics): two calls on
    the same inputs return the same bits."""
    require_cuda()
    q, k, v, mask = _attention_case(2040, 22440, 128, 512, mask_name)
    out, lse = ka.attention_plain(q, k, v, mask)
    dout = _dev(np.random.RandomState(1).randn(2040, 512))
    delta = (dout * out).sum(dim=1)
    first = ka.attention_bwd_dq(q, k, v, mask, dout, lse, delta)
    second = ka.attention_bwd_dq(q, k, v, mask, dout, lse, delta)
    assert torch.equal(first, second)


@cuda
@pytest.mark.parametrize("b,lq,lk", [(1, 2040, 22440), (8, 256, 512),
                                     (8, 64, 128), (1, 2040, 600)])
def test_attention_bwd_dkv_is_deterministic(b, lq, lk):
    """K6 with every key valid: two calls on the same inputs return the
    same bits (no atomics), at bg's shape, the `--sizes 256` training
    read, the default training batch (4 column groups) and a small read
    (4 column groups)."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, dout = (torch.randn(*s, generator=gen, device="cuda")
                     for s in ((b, lq, 128), (b, lk, 128), (b, lk, 512),
                               (b, lq, 512)))
    mask = torch.ones(b, lk, device="cuda")
    out, lse = ka.attention_plain(q, k, v, mask)
    delta = (dout * out).sum(dim=-1)
    first = ka.attention_bwd_dkv(q, k, v, mask, dout, lse, delta)
    second = ka.attention_bwd_dkv(q, k, v, mask, dout, lse, delta)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@cuda
def test_autograd_read_launches_the_kernels():
    """MaskedMemoryAttention on the card, on a batch of 3: one call each
    of K4 (the live-tile list and K4), K5 (handed K4's list: the kernel
    and the sum of its splits) and K6 (one launch), gradients as the
    plain backward's."""
    require_cuda()
    q, k, v, _, dout, _ = _batched_case(3, 64, 128, 128, 512)
    mask = _dev(np.random.RandomState(2).rand(3, 128) > 0.5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = [(c.calls, c.launches) for c in (
        ka.ATTENTION, ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)]
    out = ka.MaskedMemoryAttention.apply(q, k, v, mask)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert [(c.calls, c.launches) for c in (
        ka.ATTENTION, ka.ATTENTION_BWD_DQ, ka.ATTENTION_BWD_DKV)] == [
        (before[0][0] + 1, before[0][1] + 2),
        (before[1][0] + 1, before[1][1] + _dq_launches(3, 64, 128) - 1),
        (before[2][0] + 1, before[2][1] + 1)]
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
        km.morph(x[None, None], ellipse_offsets(3), 2, True)  # 4-D
    with pytest.raises(ValueError):
        km.trimap(x, ellipse_offsets(11), 2)        # SE reaches 5 cells
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
    # K6 holds dV in registers: dv <= 512
    wide_v = torch.cat([v, v[:, :4]], dim=1)
    with pytest.raises(ValueError):
        ka.attention_bwd_dkv(q, k, wide_v, mask, torch.cat(
            [dout, dout[:, :4]], dim=1), lse, delta)
    # the autograd read refuses what K4 refuses (dk > 128), on the card,
    # and never sends it to the plain version
    wide = _attention_case(64, 128, 132, 512, "all")
    with pytest.raises(ValueError):
        ka.MaskedMemoryAttention.apply(*wide)
    # and what K6 refuses (dv > 512) when it will need K6, at the forward
    # call; without gradients the read takes the wide V
    wide_v = _attention_case(64, 128, 128, 516, "all")
    with pytest.raises(ValueError):
        ka.MaskedMemoryAttention.apply(
            *(t.clone().requires_grad_() for t in wide_v[:3]), wide_v[3])
    assert ka.MaskedMemoryAttention.apply(*wide_v).shape == (64, 516)
    qb, kb, vb, mb, _, _ = _batched_case(3, 64, 128, 128, 512)
    with pytest.raises(ValueError):
        ka.masked_memory_attention(qb[:2].contiguous(), kb, vb, mb)  # B


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
    assert launched["attention"] == (2, 4), launched  # list + K4 a call
    # inference runs no backward
    assert launched["attention_bwd_dq"] == launched["attention_bwd_dkv"] \
        == (0, 0), launched
    for a, b in zip(card["alphas"], host["alphas"]):
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 4 and (d > 1).mean() < 1e-3, (d.max(),
                                                         (d > 1).mean())


@cuda
def test_chunk_stream_on_card():
    """The pinned double-buffered upload (`parallel/streaming.py`) under a
    slow reader: the compute stream sleeps before it reads each chunk, so
    the host runs ahead and the worker refills buffers as fast as the
    events allow; every chunk the compute stream reads must still hold
    its own index (an early refill of a pinned or device buffer would
    show)."""
    require_cuda()
    from video_unscreen_tpu_torch.parallel.streaming import ChunkStream
    n_chunks, shape = 24, (4, 256, 1024)

    def fill(i, out):
        out[...] = i % 251
        return out.shape[0]

    sums = []
    for chunk, n_valid in ChunkStream(fill, n_chunks, shape,
                                      torch.device("cuda")):
        assert n_valid == shape[0]
        torch.cuda._sleep(2_000_000)  # about 1 ms of device time
        sums.append(chunk.to(torch.int32).sum(dim=(1, 2)))
    got = torch.stack(sums).cpu()
    want = torch.tensor([[(i % 251) * shape[1] * shape[2]] * shape[0]
                         for i in range(n_chunks)], dtype=torch.int32)
    assert torch.equal(got, want)
