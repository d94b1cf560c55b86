"""Segment batching of the port's fused bg pipeline on the CPU.

`run_segmented` with S = 2 against the JAX `run_segmented` (artifacts on
the device, frames resized on the device), float32, STM tracking off and
a seeded small SCHP seed (`layers=(1, 1, 1, 1)`, crop 65) carried from the
JAX variables by `state_dict_from_variables`; then, on the port alone with
STM on, segment 0 against the sequential run of its frames with pass 1 at
full resolution (strict) and at the production 1/2 (loose), as
`tests/test_fused_bg.py` holds JAX's own, and a clip whose segments
desync (one tracks while the other seeds) segment by segment.

Tolerances: uint8 outputs within the JAX suite's bound, max |diff| <= 4
and |diff| > 1 on < 0.1% of pixels (tests/test_fused_green.py); SCHP seed
segmasks wherever the JAX logits' top-two margin exceeds 1e-3; the
production pass 1's sparse binarization flips by JAX's own bound, |diff|
> 8 on < 0.5% of pixels and a mean |diff| < 1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_bg import BG_TEST_CFG
from tests.test_pipeline_green import make_clip
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_equal
from video_unscreen_tpu.ops import geometry as jgeo
from video_unscreen_tpu.pipeline.fused_bg import FusedBgPipeline as JPipe
from video_unscreen_tpu_torch.agents.binseg import HumanSegAgent
from video_unscreen_tpu_torch.pipeline.fused_bg import \
    FusedBgPipeline as TPipe
from video_unscreen_tpu_torch.utils.checkpoint import \
    state_dict_from_variables

HW = (96, 128)
N = 4
SCHP = {"type": "human", "layers": [1, 1, 1, 1], "crop_h": 65,
        "crop_w": 65}
T32 = dict(matting_dtype=torch.float32, stm_dtype=torch.float32,
           seg_dtype=torch.float32, device="cpu")


def _within_bound(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 4, f"{what}: max |diff| {d.max()}"
    assert (d > 1).mean() < 1e-3, f"{what}: |diff| > 1 on {(d > 1).mean()}"


def _schp_variables(jseg):
    """The JAX seed's seeded variables with the BatchNorm statistics
    perturbed and class 0 favoured, so that the person mask is neither
    empty nor the whole frame."""
    rng = np.random.RandomState(3)

    def perturb(path, a):
        a = np.array(a, np.float32)
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if keys[-1] == "mean":
            return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        if "fusion_out" in keys and keys[-1] == "bias":
            a[0] += 0.33   # about half of the gap to the top class
        return a
    return jax.tree_util.tree_map_with_path(perturb, jseg.variables)


@pytest.fixture(scope="module")
def segmented():
    frames, _ = make_clip(n=N)
    cfg = dict(BG_TEST_CFG, binseg=SCHP)
    jpipe = JPipe(cfg, HW, work_long_side=128, use_stm_tracking=False,
                  fetch="device", pack_d2h=False,
                  matting_dtype=jnp.float32, stm_dtype=jnp.float32,
                  seg_dtype=jnp.float32)
    jpipe.seg.variables = _schp_variables(jpipe.seg)
    want = jpipe.run_segmented(frames, n_segments=2, chunk_size=2,
                               host_downscale=False)
    # the seed's logits on the two seeded frames (the segments' starts)
    fwd, inv = jpipe.seg._transforms(*HW)
    margins = {}
    for i in (0, N // 2):
        x = jgeo.affine_warp_axis_aligned(
            jnp.asarray(frames[i], jnp.float32), fwd, (65, 65))
        lg = jpipe.seg.model.apply(jpipe.seg.variables,
                                   jgeo.imnormalize(x)[None])[0]
        back = np.asarray(jgeo.affine_warp_axis_aligned(
            jgeo.resize(lg, (65, 65)), inv, HW))
        top2 = np.sort(back, axis=-1)[..., -2:]
        margins[i] = top2[..., 1] - top2[..., 0]
    tpipe = TPipe(cfg, HW, work_long_side=128, use_stm_tracking=False,
                  **T32)
    assert isinstance(tpipe.seg, HumanSegAgent)
    tpipe.seg.model.load_state_dict(state_dict_from_variables(
        jpipe.seg.variables))
    return frames, want, margins, tpipe


def test_run_segmented_against_jax(segmented):
    frames, want, margins, tpipe = segmented
    before = (tpipe.seg.forwards, tpipe.seg.frames)
    got = tpipe.run_segmented(frames, n_segments=2, chunk_size=2,
                              host_downscale=False)
    for name, g, w in zip(("alpha", "segmask", "fg", "bg"), got, want):
        assert g.shape[0] == N
        if name != "segmask":
            _within_bound(g, w, name)
    for i, m in margins.items():
        sure = m > 1e-3
        assert 0.0 < want[1][i].mean() < 255.0
        assert_equal(got[1][i][sure], want[1][i][sure], f"seed {i}")
    for i in (1, N - 1):   # the previous alphas, within the bound
        _within_bound(got[1][i], want[1][i], f"segmask {i}")
    # the seed ran once, on the first frame of both segments together
    assert (tpipe.seg.forwards - before[0],
            tpipe.seg.frames - before[1]) == (1, 2)
    assert tpipe.step_seeded == [(True, True), (False, False)]
    assert tpipe.stats["steps"] == 2 and "stm_steps" not in tpipe.stats


@pytest.fixture(scope="module")
def stm_pipes():
    """The port with STM on, pass 1 at full resolution and at 1/2."""
    return {p1: TPipe(BG_TEST_CFG, HW, work_long_side=128,
                      pass1_downscale=p1, **T32) for p1 in (1, 2)}


def test_segment0_matches_sequential(stm_pipes):
    frames, _ = make_clip(n=N)
    a_seq, s_seq, f_seq, b_seq = stm_pipes[1].run(frames, chunk_size=2)
    a_seg, s_seg, f_seg, b_seg = stm_pipes[1].run_segmented(
        frames, n_segments=2, chunk_size=2)
    for name, g, w in (("alpha", a_seg, a_seq), ("fg", f_seg, f_seq),
                       ("bg", b_seg, b_seq)):
        _within_bound(g[:2], w[:2], f"segment 0 {name}")
    assert_equal(s_seg[0], s_seq[0])
    # production pass 1: sparse binarization flips, no gross divergence
    a_seq2, _, _, _ = stm_pipes[2].run(frames, chunk_size=2)
    a_seg2, _, _, _ = stm_pipes[2].run_segmented(frames, n_segments=2,
                                                 chunk_size=2)
    d2 = np.abs(a_seg2[:2].astype(np.int16) - a_seq2[:2].astype(np.int16))
    assert (d2 > 8).mean() < 5e-3, (d2 > 8).mean()
    assert d2.mean() < 1.0, d2.mean()


def _desync_clip():
    """Two segments of 3 frames; segment 1's second frame is bare screen,
    so on the third step segment 0 tracks (STM on it alone) while segment
    1 re-seeds."""
    frames, _ = make_clip(n=6)
    rng = np.random.RandomState(7)
    screen = np.full(HW + (3,), (40, 190, 50), np.float32)
    screen = (screen + rng.randn(*screen.shape) * 5).clip(0, 255)
    return frames[:4] + [screen.astype(np.uint8), frames[5]]


def test_desynced_segments(stm_pipes):
    pipe = stm_pipes[1]
    frames = _desync_clip()
    got = pipe.run_segmented(frames, n_segments=2, chunk_size=3)
    assert pipe.step_tracking == [(False, False), (True, True),
                                  (True, False)]
    assert pipe.step_seeded == [(True, True), (False, False),
                                (False, True)]
    assert pipe.stats["tracked_frames"] == 3
    for s in range(2):
        seq = pipe.run(frames[3 * s:3 * s + 3], chunk_size=3)
        for name, g, w in zip(("alpha", "segmask", "fg", "bg"), got, seq):
            _within_bound(g[3 * s:3 * s + 3], w, f"segment {s} {name}")
