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
def test_wrappers_reject_bad_input():
    require_cuda()
    x = _dev(soft_mask(32, 64))
    with pytest.raises(ValueError):
        km.morph(x.t(), ellipse_offsets(3), 2, True)       # not contiguous
    with pytest.raises(ValueError):
        km.trimap(x.double(), ellipse_offsets(3), 2)        # not float32
    with pytest.raises(ValueError):
        kcc.connected_components_compact(x[None])           # not 2-D


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
