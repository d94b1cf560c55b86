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
batch: a channel whose stopping rule holds is frozen (`torch.where`), so
each channel follows exactly its own iterate, and the host reads "all
stopped" only every `_CHECK_EVERY` iterations (one sync each).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import resize
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
    (H, W) `hole`. Returns (the image with the hole filled, the CG
    iteration count of each channel)."""
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


def regionfill_with_state(img: torch.Tensor, mask: torch.Tensor,
                          factor: float = 1.0, cg_iters: int = 400,
                          tol: float = 1e-5,
                          x0: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`regionfill` that also returns the solve-resolution solution, which
    a later call can take as its warm start `x0` (at `solve_shape`).
    `img` is (H, W) or a (C, H, W) stack of channels sharing `mask`."""
    flat = img.dim() == 2
    stack = img[None] if flat else img
    if x0 is not None and flat:
        x0 = x0[None]
    h, w = stack.shape[-2:]
    if factor != 1.0:
        sh, sw = solve_shape(h, w, factor)
        hole = resize(mask.to(torch.float32), (sh, sw)) > 0
        small = resize(stack.permute(1, 2, 0), (sh, sw)).permute(2, 0, 1)
        sol, _ = _fill_core(small, hole, cg_iters, tol, x0)
        filled = resize(sol.permute(1, 2, 0), (h, w)).permute(2, 0, 1)
    else:
        sol, _ = _fill_core(stack, mask > 0, cg_iters, tol, x0)
        filled = sol
    out = torch.where(mask > 0, filled, stack)
    return (out[0], sol[0]) if flat else (out, sol)


def regionfill(img: torch.Tensor, mask: torch.Tensor, factor: float = 1.0,
               cg_iters: int = 400, tol: float = 1e-5) -> torch.Tensor:
    """Fill `img` ((H, W), or (C, H, W) channels solved independently)
    where `mask > 0` with a Laplacian membrane: optional downscale by
    `factor`, solve, upsample, and keep the known pixels. An empty mask
    passes through."""
    return regionfill_with_state(img, mask, factor, cg_iters, tol)[0]
