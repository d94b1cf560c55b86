"""The port's fused bg pipeline against the JAX `FusedBgPipeline` on the
CPU, float32 on both sides, on the JAX suite's synthetic clip and
`tests/test_pipeline_bg.py:BG_TEST_CFG` (chroma seed, the real STM and
matting weights), with STM tracking on and `memory_step` 1, so that the
ring bank of 2 fills and rolls within the 4 frames: the outputs of `run`
against JAX's scan frame by frame (what its `run` scans, artifacts on the
device), the carry after every frame, and `_ballooned` and
`_bg_model_update` on the scenarios of `tests/test_balloon_property.py`
and `tests/test_bg_ema_recovery.py`, with the recovery run itself; and
the bfloat16 STM against JAX's bfloat16 STM.

Tolerances: uint8 alphas, fg and bg within the JAX suite's bound, max
|diff| <= 4 and |diff| > 1 on < 0.1% of pixels
(tests/test_fused_green.py); seed segmasks exactly, tracked segmasks
wherever the JAX read's logits decide by more than 1e-3; the carry's
bank_n, fid, tracking and bg_seen exactly, bank_k and bank_v to 1e-4 of
their scale, bg_model and bg_prev within 1 level, alpha_pre within the
uint8 bound; the balloon flags and the EMA update exactly (equal float
math, elementwise); bfloat16 as `test_stm_bf16_against_jax` states."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_port_util import (assert_bf16_close, assert_close,
                                   assert_equal, nn_, tt)
from video_unscreen_tpu.models import stm as jstm
from video_unscreen_tpu.ops.geometry import imnormalize as j_imnormalize
from video_unscreen_tpu.parallel.data_synth import render_soft_person
from video_unscreen_tpu.pipeline.fused_bg import FusedBgPipeline as JPipe
from video_unscreen_tpu_torch.models import stm as tstm
from video_unscreen_tpu_torch.models.precision import convs_to
from video_unscreen_tpu_torch.pipeline.fused_bg import \
    FusedBgPipeline as TPipe

HW = (96, 128)
N = 4
CFG_ON = dict(BG_TEST_CFG, stm=dict(BG_TEST_CFG["stm"], memory_step=1))
F32 = dict(matting_dtype=jnp.float32, stm_dtype=jnp.float32,
           seg_dtype=jnp.float32)
T32 = dict(matting_dtype=torch.float32, stm_dtype=torch.float32,
           seg_dtype=torch.float32, device="cpu")


def _within_bound(got, want, what):
    got, want = nn_(got), nn_(want)
    assert got.shape == want.shape, what
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


def _jax_read_logits(pipe, carry, norm):
    """The JAX pipeline's STM read on one frame (its `_stm_track_mask`
    without the argmax): (H, W, 2) logits."""
    m = pipe.stm.model
    mask_prev = (carry.alpha_pre >= 128).astype(jnp.float32)
    k, v = m.apply(pipe.stm.variables, carry.frame_prev[None],
                   mask_prev[None], 1.0 - mask_prev[None],
                   method=lambda mm, f, a, b: mm.memorize(f, a, b))
    cap = pipe.bank_cap
    eff_k = jnp.concatenate([carry.bank_k[None], k[:, None]], axis=1)
    eff_v = jnp.concatenate([carry.bank_v[None], v[:, None]], axis=1)
    slot = jnp.arange(cap + 1)[None, :]
    valid = (slot < carry.bank_n) | (slot == cap)
    return m.apply(pipe.stm.variables, norm[None], eff_k, eff_v, valid,
                   method=lambda mm, f, a, b, c: mm.segment(f, a, b, c))[0]


@pytest.fixture(scope="module")
def stm_on():
    frames, gts = make_clip(n=N)
    jpipe = JPipe(CFG_ON, HW, work_long_side=128, fetch="device",
                  pack_d2h=False, **F32)
    carry, jcarries, outs, margins = jpipe.init_carry(), [], [], []
    logits_fn = jax.jit(lambda c, n: _jax_read_logits(jpipe, c, n))
    for f in frames:
        if bool(carry.tracking) and int(carry.fid) > 0:
            norm = j_imnormalize(jpipe._prep_frame(jnp.asarray(f)))
            lg = np.asarray(logits_fn(carry, norm))
            margins.append(np.abs(lg[..., 1] - lg[..., 0]))
        else:
            margins.append(None)
        carry, (packed, _) = jpipe.process_chunk(carry, jnp.asarray(f[None]))
        jcarries.append(jax.tree.map(np.asarray, carry))
        outs.append(np.asarray(packed[0]))
    tpipe = TPipe(CFG_ON, HW, work_long_side=128, **T32)
    return frames, gts, np.stack(outs), jcarries, margins, tpipe, jpipe


def test_run_against_jax(stm_on):
    frames, _, want, _, margins, tpipe, _ = stm_on
    alphas, segmasks, fgs, bgs = tpipe.run(frames, chunk_size=2)
    assert alphas.shape == (N,) + HW and fgs.shape == (N,) + HW + (3,)
    for name, got, w in (("alpha", alphas, want[..., 0]),
                         ("fg", fgs, want[..., 2:5]),
                         ("bg", bgs, want[..., 5:8])):
        _within_bound(got, w, name)
    assert tpipe.step_tracking == [(False,), (True,), (True,), (True,)]
    for i, m in enumerate(margins):
        if m is None:
            assert_equal(segmasks[i], want[i, ..., 1], f"seed segmask {i}")
        else:
            sure = m > 1e-3
            assert_equal(segmasks[i][sure], want[i, ..., 1][sure],
                         f"tracked segmask {i}")
    st = tpipe.stats
    assert (st["steps"], st["stm_steps"], st["tracked_frames"],
            st["seed_steps"]) == (N, N - 1, N - 1, 1)
    # the flag reads (1 a step, 1 more on STM steps), the CG stopping
    # checks and one fetch a chunk of 2
    assert st["syncs"] == N + (N - 1) + st["cg_syncs"] + 2
    assert st["cg_iters"] > 0 and st["cg_syncs"] >= N


@torch.inference_mode()
def test_carry_against_jax(stm_on):
    """The carry after every frame, through the ring bank's fill (frames
    1, 2) and its roll (frame 3)."""
    frames, _, _, jcarries, _, tpipe, _ = stm_on
    carry = tpipe.init_carry()
    for t, f in enumerate(frames):
        carry, _ = tpipe._step_batched(carry, torch.from_numpy(f[None]))
        want = jcarries[t]
        got = {k: nn_(v[0]) for k, v in carry._asdict().items()}
        for k in ("bank_n", "fid", "tracking", "bg_seen"):
            assert_equal(got[k], want._asdict()[k], f"frame {t} {k}")
        for k in ("bank_k", "bank_v", "frame_prev"):
            assert_close(got[k], want._asdict()[k], 1e-4, f"frame {t} {k}")
        for k in ("bg_model", "bg_prev"):
            d = np.abs(got[k] - want._asdict()[k])
            assert d.max() <= 1.0, f"frame {t} {k}: {d.max()}"
        _within_bound(got["alpha_pre"], want.alpha_pre, f"frame {t} alpha")
    assert [int(c.bank_n) for c in jcarries] == [0, 1, 2, 2]


def test_stm_bf16_against_jax(stm_on):
    """The bfloat16 STM (convolutions bf16, BatchNorm f32) against JAX's
    with `dtype=bfloat16` on the shipped weights: the memory keys and
    values by mean relative difference (float32 against bfloat16 exceeds
    the bound); the read on JAX's own bfloat16 bank to float32 accuracy
    (q, k and v upcast, as the einsum with `preferred_element_type`
    multiplies them); the tracked masks on >= 99.9% of the pixels. The
    decoder's bfloat16 logits are not held by mean difference: two
    bfloat16 runs differ there as much as bfloat16 and float32 do
    (4.2e-3 against 3.7e-3 and 4.0e-3)."""
    frames, gts, _, _, _, tpipe, jpipe = stm_on
    norm = [np.asarray(j_imnormalize(jnp.asarray(f, jnp.float32)))
            for f in frames[:3]]
    fg = [(g >= 128).astype(np.float32) for g in gts[:3]]
    nets = {dt: jstm.STM(dtype=dt, pallas_attention=False)
            for dt in (jnp.float32, jnp.bfloat16)}
    tnets = {torch.float32: tpipe.stm.model,
             torch.bfloat16: convs_to(copy.deepcopy(tpipe.stm.model),
                                      torch.bfloat16)}

    def j_memorize(dt, i):
        return nets[dt].apply(
            jpipe.stm.variables, jnp.asarray(norm[i])[None],
            jnp.asarray(fg[i])[None], 1.0 - jnp.asarray(fg[i])[None],
            method=lambda m, f, a, b: m.memorize(f, a, b))

    def t_memorize(dt, i):
        with torch.no_grad():
            return tnets[dt].memorize(tt(norm[i])[None].permute(0, 3, 1, 2),
                                      tt(fg[i])[None], 1.0 - tt(fg[i])[None])
    for i in range(2):
        want = {dt: [np.asarray(a.astype(jnp.float32))
                     for a in j_memorize(dt, i)] for dt in nets}
        got = {dt: [nn_(a.float()) for a in t_memorize(dt, i)]
               for dt in tnets}
        for j, name in enumerate(("keys", "values")):
            assert_bf16_close(got[torch.bfloat16][j],
                              want[jnp.bfloat16][j], 1e-3,
                              [(got[torch.float32][j],
                                want[jnp.bfloat16][j]),
                               (got[torch.bfloat16][j],
                                want[jnp.float32][j])],
                              f"frame {i} memory {name}")
    (k0, v0), (k1, v1) = j_memorize(jnp.bfloat16, 0), j_memorize(
        jnp.bfloat16, 1)
    bank_k = jnp.stack([k0, jnp.zeros_like(k0), k1], axis=1)
    bank_v = jnp.stack([v0, jnp.zeros_like(v0), v1], axis=1)
    valid = np.array([[True, False, True]])
    q_k, q_v = k1 * 0.5, v1        # any bfloat16 query
    want = jstm.memory_read(bank_k, bank_v, jnp.asarray(valid), q_k, q_v,
                            use_pallas=False)
    bf = (lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(torch.bfloat16))
    got = tstm.memory_read(bf(bank_k), bf(bank_v), torch.from_numpy(valid),
                           bf(q_k), bf(q_v))
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want.astype(jnp.float32)), 1e-5,
                 "bfloat16-stored read")
    segment = jax.jit(lambda f, k, v: nets[jnp.bfloat16].apply(
        jpipe.stm.variables, f[None], k, v, jnp.asarray(valid),
        method=lambda m, *a: m.segment(*a))[0])
    want = np.asarray(segment(jnp.asarray(norm[2]), bank_k, bank_v))
    with torch.no_grad():
        got = tnets[torch.bfloat16].segment(
            tt(norm[2])[None].permute(0, 3, 1, 2), bf(bank_k), bf(bank_v),
            torch.from_numpy(valid))[0]
    agree = (nn_(got.argmax(0)) == want.argmax(-1)).mean()
    assert agree >= 0.999, agree


def _person(scale, phase, h=162, w=288):
    rng = np.random.RandomState(7)
    _, a = render_soft_person(rng, h, w, ss=2, scale=scale, phase=phase,
                              cx_frac=0.5)
    return (a * 255.0).astype(np.float32)


@pytest.fixture(scope="module")
def pipes_off():
    """Both pipelines without STM (the scenarios' own configuration)."""
    cfg = dict(BG_TEST_CFG, stm=dict(BG_TEST_CFG["stm"], balloon_ratio=1.6))
    return (JPipe(cfg, HW, work_long_side=128, use_stm_tracking=False,
                  pack_d2h=False, **F32),
            TPipe(cfg, HW, work_long_side=128, use_stm_tracking=False,
                  **T32))


def test_ballooned(pipes_off):
    """A fast approach (+12% scale) is not flagged, the person absorbing
    the smallest pillar is; alone and as a batch of both."""
    jpipe, tpipe = pipes_off
    prev = _person(0.45, 0.0)
    grown = _person(0.45 * 1.12, 2.0 * np.pi / 8.0)
    latched = grown.copy()
    latched[:, 144:144 + int(288 * 0.05)] = 255.0
    for m, flag in ((grown, False), (latched, True)):
        want = bool(jpipe._ballooned(jnp.asarray(m), jnp.asarray(prev)))
        assert want is flag
        assert bool(tpipe._ballooned(tt(m), tt(prev))) is flag
    got = tpipe._ballooned(tt(np.stack([grown, latched])),
                           tt(np.stack([prev, prev])))
    assert got.tolist() == [False, True]


def test_bg_model_update(pipes_off):
    """The EMA update on the trap's states: a poisoned EMA (the subject
    absorbed, every pixel seen, nothing tracked) and a fresh one, under a
    matte that missed the subject and a seed that finds half of it."""
    jpipe, tpipe = pipes_off
    frames, _ = make_clip(n=1)
    rng = np.random.RandomState(8)
    frame = np.asarray(jpipe._prep_frame(jnp.asarray(frames[0],
                                                     jnp.float32)))
    segmask = np.where(np.arange(HW[1])[None, :] < HW[1] // 2, 255.0,
                       0.0) * np.ones(HW, np.float32)
    alpha = np.where(rng.rand(*HW) < 0.3, 0.0, 200.0).astype(np.float32)
    bgimg = rng.uniform(0, 255, HW + (3,)).astype(np.float32)
    for poisoned in (True, False):
        jc = jpipe.init_carry()
        if poisoned:
            jc = jc._replace(bg_model=jnp.asarray(frame),
                             bg_seen=jnp.ones(HW, jnp.float32))
        for a in (alpha, np.zeros(HW, np.float32)):
            want = jpipe._bg_model_update(jc, jnp.asarray(frame),
                                          jnp.asarray(a),
                                          jnp.asarray(segmask),
                                          jnp.asarray(bgimg))
            tc = tpipe.init_carry()._replace(
                bg_model=tt(np.asarray(jc.bg_model))[None],
                bg_seen=tt(np.asarray(jc.bg_seen))[None])
            got = tpipe._bg_model_update(tc, tt(frame)[None], tt(a)[None],
                                         tt(segmask)[None], tt(bgimg)[None])
            for g, w, name in zip(got, want, ("bg_model", "bg_seen")):
                assert_equal(g[0], w, f"poisoned={poisoned} {name}")


def test_poisoned_ema_recovers(pipes_off):
    """tests/test_bg_ema_recovery.py's run on the port: the subject
    absorbed into the EMA comes back within a few frames and stays."""
    _, tpipe = pipes_off
    frames, gts = make_clip(n=1)
    carry = tpipe.init_carry()
    with torch.inference_mode():
        frame_w = tpipe._prep_frames(torch.from_numpy(frames[0][None]))
        carry = carry._replace(bg_model=frame_w,
                               bg_seen=torch.ones((1,) + HW))
        means = []
        for _ in range(6):
            carry, out = tpipe._step_batched(carry,
                                             torch.from_numpy(frames[0][None]))
            means.append(float(out[0, ..., 0].float().mean()))
    gt_mean = float(np.asarray(gts[0], np.float32).mean())
    assert means[-1] > 0.5 * gt_mean, means
    assert means[-1] >= 0.9 * max(means), means
