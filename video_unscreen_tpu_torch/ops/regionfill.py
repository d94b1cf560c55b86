"""Laplacian membrane inpainting (regionfill) as a matrix-free CG solve.

Port of `video_unscreen_tpu/ops/regionfill.py`. The system, on the hole:

    n_i x_i - sum_{j in hole, j ~ i} x_j = sum_{j in perimeter, j ~ i} I_j

with n_i the number of in-grid neighbours (4 inside, 3 on an edge, 2 in a
corner) and perimeter = cross-dilate(hole) & ~hole; the identity block
outside the hole keeps the operator full-rank without coupling into it.

The CG iteration is that of `jax.scipy.sparse.linalg.cg` (the reference's
solver), step for step: r0 = b - A x0, p0 = r0, gamma = r.r; while
gamma > max(tol^2 b.b, 0) and k < maxiter: alpha = gamma / p.Ap,
x += alpha p, r -= alpha Ap, gamma' = r.r, p = r + (gamma' / gamma) p.

The channels of a (C, H, W) image are C independent solves run as one
batch, over one shared (H, W) hole or a (C, H, W) hole each (the fused bg
pipeline's S segments x 3 channels): a channel whose stopping rule holds
is frozen (`torch.where`), so each channel follows exactly its own
iterate and stops on the iteration its own JAX `while_loop` stops, and the
host reads "all stopped" only every `_CHECK_EVERY` iterations (one sync
each; `cg_syncs` counts them from the iteration counts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import resize_nchw
from .morphology import cross_offsets
from .kernels.morph import morph as _morph

_CHECK_EVERY = 16


def _num_neighbors(h: int, w: int) -> np.ndarray:
    nn = np.full((h, w), 4.0, np.float32)
    nn[0, :] -= 1
    nn[-1, :] -= 1
    nn[:, 0] -= 1
    nn[:, -1] -= 1
    return nn


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 neighbours of each cell of a (C, H, W) stack, 0 outside
    the grid, added in the reference's order: below, above, right, left."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    return (((xp[:, 2:h + 2, 1:w + 1] + xp[:, 0:h, 1:w + 1])
             + xp[:, 1:h + 1, 2:w + 2]) + xp[:, 1:h + 1, 0:w])


def _fill_core(img: torch.Tensor, hole: torch.Tensor, cg_iters: int,
               tol: float, x0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the membrane of each channel of `img` (C, H, W) over the bool
    (H, W) or (C, H, W) `hole`. Returns (the image with the hole filled,
    the CG iteration count of each channel)."""
    c, h, w = img.shape
    dilated = _morph(hole.to(torch.float32), cross_offsets(3), 1, True)
    perimeter = (dilated > 0) & ~hole
    rhs = _neighbor_sum(torch.where(perimeter, img, 0.0))
    b = torch.where(hole, rhs, 0.0)
    nn = torch.as_tensor(_num_neighbors(h, w), device=img.device)

    def matvec(x):
        x_in = torch.where(hole, x, 0.0)
        return torch.where(hole, nn * x_in - _neighbor_sum(x_in), x)

    def dot(u, v):
        return (u * v).sum(dim=(1, 2))

    # outside-hole entries of the identity block start at rhs (= 0), so
    # the residual measures only the hole system
    x = torch.zeros_like(img) if x0 is None else torch.where(hole, x0, 0.0)
    atol2 = torch.clamp_min(tol * tol * dot(b, b), 0.0)
    r = b - matvec(x)
    p = r
    gamma = dot(r, r)
    k = torch.zeros(c, dtype=torch.int32, device=img.device)
    while True:
        for _ in range(_CHECK_EVERY):
            go = (gamma > atol2) & (k < cg_iters)
            ap = matvec(p)
            alpha = gamma / dot(p, ap)
            g = go[:, None, None]
            x_n = x + alpha[:, None, None] * p
            r_n = r - alpha[:, None, None] * ap
            gamma_n = dot(r_n, r_n)
            p_n = r_n + (gamma_n / gamma)[:, None, None] * p
            x = torch.where(g, x_n, x)
            r = torch.where(g, r_n, r)
            p = torch.where(g, p_n, p)
            gamma = torch.where(go, gamma_n, gamma)
            k = k + go.to(torch.int32)
        if not bool(((gamma > atol2) & (k < cg_iters)).any()):
            break
    return torch.where(hole, x, img), k


def solve_shape(h: int, w: int, factor: float = 1.0) -> Tuple[int, int]:
    """The (sh, sw) resolution `_fill_core` solves at for `factor`."""
    if factor == 1.0:
        return h, w
    return max(int(h * factor), 1), max(int(w * factor), 1)


def cg_syncs(iters: torch.Tensor) -> int:
    """Host syncs `_fill_core` made for a solve whose channels took
    `iters` iterations: one every `_CHECK_EVERY`, at least one."""
    return max(1, -(-int(iters.max()) // _CHECK_EVERY))


def _resize_planes(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """"linear" `resize` of each plane of a (C, H, W) stack."""
    return resize_nchw(x[None], hw)[0]


def regionfill_solve(img: torch.Tensor, mask: torch.Tensor,
                     factor: float = 1.0, cg_iters: int = 400,
                     tol: float = 1e-5, x0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fill each channel of a (C, H, W) stack where its (H, W) or (C, H, W)
    `mask` is > 0 with a Laplacian membrane: optional downscale by
    `factor`, solve (warm-started from `x0` at `solve_shape`), upsample,
    and keep the known pixels. An empty mask passes through. Returns
    (filled, the solve-resolution solution, the CG iterations of each
    channel (C,))."""
    h, w = img.shape[-2:]
    if factor != 1.0:
        sh, sw = solve_shape(h, w, factor)
        hole = _resize_planes(mask.to(torch.float32).reshape(-1, h, w),
                              (sh, sw)) > 0
        small = _resize_planes(img, (sh, sw))
        sol, iters = _fill_core(small, hole, cg_iters, tol, x0)
        filled = _resize_planes(sol, (h, w))
    else:
        sol, iters = _fill_core(img, mask > 0, cg_iters, tol, x0)
        filled = sol
    return torch.where(mask > 0, filled, img), sol, iters


def regionfill_with_state(img: torch.Tensor, mask: torch.Tensor,
                          factor: float = 1.0, cg_iters: int = 400,
                          tol: float = 1e-5,
                          x0: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's `regionfill_with_state` under its name, kept for the parity
    tests (the port's pipelines call `regionfill_solve`): (filled, the
    solve-resolution solution) of an (H, W) image or a (C, H, W) stack."""
    flat = img.dim() == 2
    if flat:
        img = img[None]
        x0 = None if x0 is None else x0[None]
    out, sol, _ = regionfill_solve(img, mask, factor, cg_iters, tol, x0)
    return (out[0], sol[0]) if flat else (out, sol)


def regionfill(img: torch.Tensor, mask: torch.Tensor, factor: float = 1.0,
               cg_iters: int = 400, tol: float = 1e-5) -> torch.Tensor:
    """JAX's `regionfill` under its name, kept for the parity tests: the
    filled (H, W) image or (C, H, W) stack."""
    return regionfill_with_state(img, mask, factor, cg_iters, tol)[0]
