"""bg_offline in the port against the JAX package on the CPU: the three
stages, fused and modular, on the JAX suite's synthetic clip (5 frames of
96x128, chunks of 2, so that stage 1's last chunk is padded by replaying
its last frame) with `tests/test_pipeline_bg.py:BG_TEST_CFG` (chroma seed,
the real STM and matting weights), STM tracking on and `memory_step` 1, so
that the ring bank of 2 fills and rolls.

Both packages run in float32: each `fused_bg` module gets, for this file
only, a `FusedBgPipeline` that passes the float32 dtypes (the JAX side
builds one pipeline per configuration and hands it out again: its jitted
scans are keyed on the pipeline, and it holds no state between calls, so
the stage-3 resume compiles nothing new). Spies on each package's stage
functions record what `run` computed in memory.

Tolerances: uint8 backgrounds, alphas and fg within the JAX suite's bound
for reassociated float math, max |diff| <= 4 and |diff| > 1 on < 0.1% of
pixels (tests/test_fused_green.py); seed segmasks exactly, tracked
segmasks (an argmax of the STM read) on >= 99.9% of the pixels;
`ema_seen` exactly and `ema_bg`, `always_bg` within 1 level; the stage-2
sums `acc` and `cnt` bit-exact (whole numbers below 2^24)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_port_util import assert_equal, nn_, tt
from video_unscreen_tpu.agents.trimap import TrimapAgent as JTrimap
from video_unscreen_tpu.agents.vmatting import VMattingAgent as JVMat
from video_unscreen_tpu.pipeline import bg_offline as jbo
from video_unscreen_tpu.pipeline import fused_bg as jfb
from video_unscreen_tpu_torch.pipeline import bg_offline as tbo
from video_unscreen_tpu_torch.pipeline import fused_bg as tfb

N, CHUNK, WORK = 5, 2, 128
CFG = dict(BG_TEST_CFG, stm=dict(BG_TEST_CFG["stm"], memory_step=1))
_JPipe = jfb.FusedBgPipeline
_JPIPES = {}


def _jax_f32_pipe(cfg, frame_hw, work_long_side=960, use_stm_tracking=True):
    key = (json.dumps({k: v for k, v in cfg.items() if k != "data"},
                      sort_keys=True),
           tuple(frame_hw), work_long_side, use_stm_tracking)
    if key not in _JPIPES:
        _JPIPES[key] = _JPipe(
            cfg, frame_hw, work_long_side=work_long_side,
            use_stm_tracking=use_stm_tracking, matting_dtype=jnp.float32,
            stm_dtype=jnp.float32, seg_dtype=jnp.float32, fetch="device",
            pack_d2h=False)
    return _JPIPES[key]


class _TorchF32(tfb.FusedBgPipeline):
    def __init__(self, *args, **kw):
        kw.update(matting_dtype=torch.float32, stm_dtype=torch.float32,
                  seg_dtype=torch.float32)
        super().__init__(*args, **kw)


def _spy(mp, module, name, log):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.setdefault(name, []).append(out)
        return out
    mp.setattr(module, name, wrapped)


def _cfg(dst):
    """CFG with its store in `dst` and the video directory beside it (the
    JAX package's mux writes a video there; the port's does not)."""
    return dict(CFG, data={"dst_img_dir": str(dst), "range": None,
                           "dst_vid_dir": f"{dst}_video", "video_id": "t"})


def _within_bound(got, want, what):
    got, want = nn_(got), nn_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


def _within_one(got, want, what):
    d = np.abs(nn_(got).astype(np.int64) - nn_(want).astype(np.int64))
    assert d.max() <= 1, f"{what}: max |diff| {d.max()}"


def _segmasks_agree(got, want, seeded, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if seeded[i]:
            assert_equal(g, w, f"{what}: seed segmask {i}")
        else:
            agree = (nn_(g) == nn_(w)).mean()
            assert agree >= 0.999, f"{what}: tracked segmask {i}: {agree}"


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """Both packages' fused `run` (stages 1-3, save=True, each into its
    own store), then the stage-3 resume from each store."""
    frames, gts = make_clip(n=N)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfb, "FusedBgPipeline", _jax_f32_pipe)
        mp.setattr(tfb, "FusedBgPipeline", _TorchF32)
        for name, mod, kw in (("jax", jbo, {}), ("torch", tbo,
                                                 {"device": "cpu"})):
            log = {}
            with pytest.MonkeyPatch.context() as spies:
                for fn in ("_chunked_scan", "_stage1_fused", "_stage2"):
                    _spy(spies, mod, fn, log)
                cfg = _cfg(tmp_path_factory.mktemp(f"store_{name}"))
                res = mod.run(cfg, frames=frames, save=True,
                              stages=(1, 2, 3), fused=True,
                              work_long_side=WORK, chunk_size=CHUNK, **kw)
            resumed = mod.run(cfg, frames=frames, save=False, stages=(3,),
                              fused=True, work_long_side=WORK,
                              chunk_size=CHUNK, **kw)
            out[name] = dict(res=res, log=log, cfg=cfg, resumed=resumed)
    return frames, gts, out


def test_fused_stage1_against_jax(fused):
    """Per frame: the segmask and the per-frame background; the EMA pair
    of the carry left after the replayed pad frame."""
    _, _, out = fused
    j1, t1 = (out[k]["log"]["_stage1_fused"][0] for k in ("jax", "torch"))
    jpack, tpack = (out[k]["log"]["_chunked_scan"][0][1]
                    for k in ("jax", "torch"))
    tpipe = t1[2]
    # frame 0 seeds; frames 1-4 track (the tail chunk's pad step too)
    assert tpipe.step_tracking == [(False,), (True,), (True,), (True,),
                                   (True,), (True,)]
    seeded = [s[0] for s in tpipe.step_seeded]
    _segmasks_agree(tpack[..., 0], jpack[..., 0], seeded, "stage 1")
    for i in range(N):
        _within_bound(tpack[i, ..., 1:4], jpack[i, ..., 1:4], f"bg {i}")
        assert_equal(t1[0][i], np.stack([tpack[i, ..., 0]] * 3, axis=2))
    (jb, js), (tb, ts) = j1[3], t1[3]
    assert_equal(ts, js, "ema_seen")
    assert js.dtype == ts.dtype == np.uint8 and 0 < (ts > 0).mean() < 1
    _within_one(tb, jb, "ema_bg")
    assert tpipe.stats["steps"] == N + 1 and tpipe.stats["cg_iters"] > 0


def test_stage1_tail_replay_moves_the_ema(fused):
    """The pad step is not idempotent for the EMA: without it, the port's
    EMA would differ from the JAX one. The tail replay is what holds
    it."""
    frames, _, out = fused
    pipe = out["torch"]["log"]["_stage1_fused"][0][2]
    hw = pipe.work_hw
    frames_w = tbo.host_frames(frames, hw)
    no_pad, _ = tbo._chunked_scan(pipe.process_chunk_stage1,
                                  pipe.init_carry(), [frames_w], CHUNK)
    padded = out["torch"]["log"]["_stage1_fused"][0][3][0]
    ema = no_pad.bg_model[0].clamp(0, 255).to(torch.uint8).numpy()
    assert (ema != padded).any()


def test_fused_stage2_and_stage3_against_jax(fused):
    """always_bg (5 frames: every pixel seen 10 times or fewer, so the
    hole is the whole frame), then per frame the alpha and the fg of
    stage 3 and the alphas `run` returns."""
    _, _, out = fused
    j2 = out["jax"]["log"]["_stage2"][0]
    t2, iters = out["torch"]["log"]["_stage2"][0]
    _within_one(t2, j2, "always_bg")
    assert iters == [0, 0, 0]
    jpack, tpack = (out[k]["log"]["_chunked_scan"][1][1]
                    for k in ("jax", "torch"))
    for i in range(N):
        _within_bound(tpack[i, ..., 0], jpack[i, ..., 0], f"alpha {i}")
        _within_bound(tpack[i, ..., 1:4], jpack[i, ..., 1:4], f"fg {i}")
        _within_bound(out["torch"]["res"]["alphas"][i],
                      out["jax"]["res"]["alphas"][i], f"run alpha {i}")
    res = out["torch"]["res"]
    assert res["numframes"] == N and set(res["seconds"]) == {
        "stage1", "stage2", "stage3"}
    for i in range(N):
        assert_equal(res["fgs"][i], tpack[i, ..., 1:4])
    assert_equal(res["always_bg"], t2)
    assert_equal(res["ema"][1], out["torch"]["log"]["_stage1_fused"][0][3][1])


def test_fused_stores_and_resume_against_jax(fused):
    """The same artifact names in both stores, the EMA PNGs equal in
    content, and the stage-3 resume from each package's own store."""
    _, gts, out = fused
    stores = {k: out[k]["cfg"]["data"]["dst_img_dir"] for k in out}
    names = {k: sorted(os.listdir(v)) for k, v in stores.items()}
    assert names["torch"] == names["jax"]
    assert len(names["jax"]) == 4 * N + 3
    import cv2
    for f in ("ema_seen.png", "ema_bg.png"):
        a, b = (cv2.imread(os.path.join(stores[k], f), cv2.IMREAD_UNCHANGED)
                for k in ("jax", "torch"))
        (assert_equal if "seen" in f else _within_one)(b, a, f)
    for i in range(N):
        _within_bound(out["torch"]["resumed"]["alphas"][i],
                      out["jax"]["resumed"]["alphas"][i], f"resumed {i}")
    from tests.test_bg_offline import M  # the JAX suite's metric
    ious = [float(M.miou(jnp.asarray((g[::1, ::1] > 0) * 255.0),
                         jnp.asarray(a, jnp.float32)))
            for a, g in zip(out["torch"]["resumed"]["alphas"], gts)]
    assert np.mean(ious) > 0.6, ious


def test_process_chunk_stage1_against_jax_scan(fused):
    """`process_chunk_stage1` chunk by chunk against JAX's scan on the
    same carry: the packed outputs and the carry after each chunk,
    through the ring bank's fill and roll."""
    frames, _, _ = fused
    jpipe = _jax_f32_pipe(CFG, frames[0].shape[:2], WORK)
    tpipe = _TorchF32(CFG, frames[0].shape[:2], work_long_side=WORK,
                      device="cpu")
    jc, tc = jpipe.init_carry(), tpipe.init_carry()
    x = np.stack(frames[:4])
    banks = []
    for c0 in (0, 2):
        jc, jp = jpipe.process_chunk_stage1(jc, jnp.asarray(x[c0:c0 + 2]))
        tc, tp = tpipe.process_chunk_stage1(tc, x[c0:c0 + 2])
        seeded = [s[0] for s in tpipe.step_seeded[c0:c0 + 2]]
        _segmasks_agree(tp[..., 0], np.asarray(jp)[..., 0], seeded,
                        f"chunk {c0}")
        _within_bound(tp[..., 1:4], np.asarray(jp)[..., 1:4],
                      f"chunk {c0} bg")
        for k in ("bank_n", "fid", "tracking", "bg_seen"):
            assert_equal(getattr(tc, k)[0], np.asarray(getattr(jc, k)), k)
        for k in ("bank_k", "bank_v"):
            d = np.abs(nn_(getattr(tc, k)[0]) - np.asarray(getattr(jc, k)))
            assert d.max() <= 1e-4 * max(1.0, np.abs(np.asarray(
                getattr(jc, k))).max()), (k, d.max())
        _within_one(tc.bg_model[0], np.asarray(jc.bg_model), "bg_model")
        banks.append(int(tc.bank_n[0]))
    assert banks == [1, 2]


def test_stage2_accum_bit_exact():
    """Two chunks folded into the sums, masks whose three channels differ
    (saturated, just below 250, soft), against JAX's scan: acc and cnt
    bit for bit."""
    rng = np.random.RandomState(3)
    h, w = 40, 56
    acc_j = jnp.zeros((h, w, 3), jnp.float32)
    cnt_j = jnp.zeros((h, w, 3), jnp.float32)
    acc_t, cnt_t = torch.zeros((h, w, 3)), torch.zeros((h, w, 3))
    for n in (3, 3):
        frames = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
        masks = np.zeros((n, h, w, 3), np.uint8)
        masks[:, 10:30, 12:40, 0] = 255
        masks[:, 12:32, 14:42, 1] = 249
        masks[..., 2] = rng.randint(0, 256, (n, h, w)).astype(np.uint8)
        masks[rng.rand(n, h, w, 3) < 0.02] = 255
        acc_j, cnt_j = jbo._stage2_accum(acc_j, cnt_j, jnp.asarray(frames),
                                         jnp.asarray(masks))
        acc_t, cnt_t = tbo._stage2_accum(acc_t, cnt_t, tt(frames),
                                         tt(masks))
        assert_equal(acc_t, acc_j, "acc")
        assert_equal(cnt_t, cnt_j, "cnt")
    assert len(torch.unique(cnt_t)) > 2 and float(acc_t.max()) > 0


def test_stage2_finalize_against_jax():
    """The mean and the always-foreground hole filled by CG: a frame
    whose middle was background in only 5 of 15 frames, so the solve has
    a boundary and runs; within 1 level, and the iterations of each
    channel."""
    rng = np.random.RandomState(4)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3.0, yy * 4.0, (xx + yy) * 1.5], -1) + 20.0
    cnt = np.full((h, w, 3), 15.0, np.float32)
    cnt[((yy - 24) ** 2 / 150 + (xx - 30) ** 2 / 200) < 1] = 5.0
    acc = (cnt * (base + rng.uniform(-3, 3, base.shape))).round().astype(
        np.float32)
    want = np.asarray(jbo._stage2_finalize(jnp.asarray(acc),
                                           jnp.asarray(cnt)))
    got, iters = tbo._stage2_finalize(tt(acc), tt(cnt))
    _within_one(got, want, "always_bg")
    assert got.dtype == torch.uint8 and min(iters.tolist()) > 10


@pytest.fixture(scope="module")
def modular(tmp_path_factory):
    """The modular stages: JAX's `run(fused=False)` for stages 1 and 2
    (its stage 3 cannot run: the module never imports the agents it
    calls) and the port's for all three."""
    frames, gts = make_clip(n=N)
    out = {}
    for name, mod, kw in (("jax", jbo, {}), ("torch", tbo,
                                             {"device": "cpu"})):
        log = {}
        with pytest.MonkeyPatch.context() as spies:
            for fn in ("_stage1", "_stage2"):
                _spy(spies, mod, fn, log)
            res = mod.run(_cfg(tmp_path_factory.mktemp(f"mod_{name}")),
                          frames=frames, save=False,
                          stages=(1, 2) if name == "jax" else (1, 2, 3),
                          fused=False, **kw)
        out[name] = dict(res=res, log=log)
    return frames, gts, out


def test_modular_stages_1_and_2_against_jax(modular):
    frames, _, out = modular
    (jm, jb), (tm, tb) = (out[k]["log"]["_stage1"][0]
                          for k in ("jax", "torch"))
    _segmasks_agree([m[..., 0] for m in tm], [m[..., 0] for m in jm],
                    [True] + [False] * (N - 1), "modular stage 1")
    for i in range(N):
        _within_bound(tb[i], jb[i], f"modular bg {i}")
    j2 = out["jax"]["log"]["_stage2"][0]
    _within_one(out["torch"]["log"]["_stage2"][0][0], j2, "always_bg")
    alphas = out["torch"]["res"]["alphas"]
    assert len(alphas) == N and alphas[0].shape == frames[0].shape[:2]


def test_modular_stage3_against_jax(modular, monkeypatch, tmp_path):
    """JAX's `_stage3` with the two names it lacks supplied by the test,
    against the port's on JAX's own stage-1 and stage-2 outputs."""
    frames, gts, out = modular
    monkeypatch.setattr(jbo, "TrimapAgent", JTrimap, raising=False)
    monkeypatch.setattr(jbo, "VMattingAgent", JVMat, raising=False)
    masks, bgs = out["jax"]["log"]["_stage1"][0]
    always = out["jax"]["log"]["_stage2"][0]
    want = jbo._stage3(CFG, frames, masks, bgs, always, str(tmp_path),
                       False)
    got, fgs = tbo._stage3(CFG, frames, masks, bgs, always, str(tmp_path),
                           False, device="cpu")
    for i in range(N):
        _within_bound(got[i], want[i], f"modular stage 3 alpha {i}")
    assert len(fgs) == N and fgs[0].shape == frames[0].shape
    ious = [float(((a >= 128) & (g > 0)).sum() / ((a >= 128) | (g > 0)).sum())
            for a, g in zip(out["torch"]["res"]["alphas"], gts)]
    assert np.mean(ious) > 0.6, ious
