"""The cases K1 and K2 are held and timed on, shared by the port's tests
and `chip_smoke.py`.

`MORPH_CALLS` lists every K1 and K2 call the green, bg, fused bg,
bg_offline, background-model, training and evaluation paths make. The hard masks
break iterated morphology at the image's border: all 255 and all 0 (the
fill must neither grow nor erode the border), one hot pixel at each
corner, a 1-pixel line along each edge, and a checkerboard (every cell
differs from its four neighbours)."""

# (kernel, caller, (h, w), SE, iters, batch). The trimap is the k3
# ellipse (the 5-point cross); "cross3" is regionfill's cross_offsets(3),
# the same five cells; "ellipse<k>" the k x k ellipse, anchored at
# (k // 2, k // 2). `batch` is the planes of the batch a call is held on:
# the most a path gives it in one call, and at least run_segmented's S = 8
# (S segments give a call S times its planes a frame: the fused bg
# regionfill solves the 3 channels of each segment, each behind its own
# hole; bg_offline's stage 2 dilates the 3 channels of a chunk of 32
# frames in one call).
MORPH_CALLS = (
    ("trimap", "green and fused bg trimap (ops/trimap.py:22)", (544, 960),
     "ellipse3", 5, 8),
    ("trimap", "bg trimap (agents/trimap.py:38)", (540, 960), "ellipse3", 5,
     8),
    ("morph", "colour filter / seed close and open / fused bg hole "
     "(pipeline/fused_bg.py:297)", (544, 960), "ellipse3", 2, 8),
    ("morph", "green band tier 1", (544, 960), "ellipse3", 10, 8),
    ("morph", "green band tier 2", (544, 960), "ellipse3", 20, 8),
    ("morph", "green band tier 3", (544, 960), "ellipse3", 40, 8),
    ("morph", "bg background mask (pipeline/bg.py:63)", (1080, 1920),
     "ellipse3", 2, 8),
    ("morph", "regionfill perimeter (ops/regionfill.py:65)", (1080, 1920),
     "cross3", 1, 8),
    ("morph", "bg alpha dilate (pipeline/bg.py:112)", (1080, 1920),
     "ellipse4", 2, 8),
    ("morph", "fused bg background-difference dilate "
     "(pipeline/fused_bg.py:392)", (544, 960), "ellipse4", 2, 8),
    ("morph", "fused bg regionfill perimeter (ops/regionfill.py:65)",
     (272, 480), "cross3", 1, 24),
    ("morph", "bg_offline stage 2 mask dilate, 32 frames x 3 channels "
     "(pipeline/bg_offline.py:_stage2_accum)", (1080, 1920), "ellipse3", 2,
     96),
    ("morph", "bg_offline stage 2 always-fg hole "
     "(pipeline/bg_offline.py:_stage2_finalize)", (1080, 1920), "ellipse3",
     2, 8),
    ("morph", "BackgroundAgent dilate (agents/bgmodel.py:_dilated)",
     (303, 540), "ellipse5", 3, 8),
    ("morph", "BackgroundAgent outer boundary (ops/morphology.py:"
     "get_outer_boundary)", (303, 540), "ellipse7", 10, 8),
    ("morph", "BackgroundAgent rf regionfill perimeter "
     "(ops/regionfill.py:65)", (151, 270), "cross3", 1, 8),
    ("morph", "evaluation roi_sad boundary band, dilate and erode "
     "(ops/metrics.py:roi_sad)", (1080, 1920), "ellipse5", 10, 8),
)

MORPH_HARD_MASKS = ("full", "empty", "corners", "edges", "checkerboard")


def se_offsets(se):
    """The (dy, dx) cells of a MORPH_CALLS SE name ("ellipse<k>",
    "cross3")."""
    from ..morphology import cross_offsets, ellipse_offsets
    if se == "cross3":
        return cross_offsets(3)
    assert se.startswith("ellipse"), se
    return ellipse_offsets(int(se[len("ellipse"):]))


def morph_hard_mask(name, h, w):
    """One of MORPH_HARD_MASKS as an (h, w) 0/255 f32 array."""
    import numpy as np
    m = np.zeros((h, w), np.float32)
    if name == "full":
        m[:] = 255.0
    elif name == "corners":
        m[0, 0] = m[0, -1] = m[-1, 0] = m[-1, -1] = 255.0
    elif name == "edges":
        m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 255.0
    elif name == "checkerboard":
        yy, xx = np.mgrid[0:h, 0:w]
        m = ((yy + xx) % 2 == 0).astype(np.float32) * 255.0
    else:
        assert name == "empty", name
    return m
