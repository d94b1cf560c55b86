"""ISegAgent: click-based interactive segmentation with optional BRS.

Port of `video_unscreen_tpu/agents/iseg.py` (`Clicker`, `ISegAgent`).
Click history is host bookkeeping (`Clicker`); the forward is
`models/iseg.py:DistMapsModel` over a fixed-size click tensor, with
optional flip test-time augmentation (the clicks' x mirrored) and
optional BRS: a per-channel (scale, bias) at the insertion point,
optimized so that the prediction agrees with the clicks.

BRS minimizes the click-miss loss plus an L2 term on (scale, bias) with
the gradient from `torch.autograd` through the part after the insertion
point only: the features before it are computed once, without grad. The
JAX package runs `optax.lbfgs()` for `brs_maxiter` steps in a
`lax.scan`; the port keeps its own L-BFGS, written step for step as optax
0.2.6 writes it (`lbfgs_minimize`): memory 10, the initial inverse
Hessian scaled (the first step by min(1, 1 / |g|)), and the zoom line
search with optax's defaults (at most 20 steps, the guess 1.0 each time,
slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, increase factor 2,
stepsize precision 1e-5). The vectors stay on the device; the line
search's scalar logic runs on the host in float32, as optax's does in
float32 on the device, so each line-search step reads its value and slope
back: one host sync a step, and one at the start of each iteration.
`ISegAgent.brs_stats` holds the last BRS call's iterations, function
evaluations (each a forward and a backward of the head) and host syncs.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.iseg import INSERTION_MODES, DistMapsModel
from ..models.precision import convs_to, empty_module
from ..ops.geometry import (get_target_size, imnormalize, inv_pad_resize,
                            pad_resize)
from ..parallel.train import init_flax_like
from ..utils.checkpoint import load_iseg
from ..utils.device import as_float, resolve_device

Click = namedtuple("Click", ["is_positive", "coords"])


class Clicker:
    """Click bookkeeping and the clicks' square maps of `click_radius`."""

    def __init__(self, shape_hw: Tuple[int, int], click_radius: int = 1):
        self.height, self.width = shape_hw
        self.radius = click_radius
        self.clicks_list: List[Click] = []

    def add_click(self, is_positive: bool, y: int, x: int):
        self.clicks_list.append(Click(is_positive, (int(y), int(x))))

    def get_clicks_maps(self):
        pos = np.zeros((self.height, self.width), np.float32)
        neg = np.zeros_like(pos)
        r = self.radius
        for click in self.clicks_list:
            y, x = click.coords
            target = pos if click.is_positive else neg
            target[max(y - r, 0):y + r + 1, max(x - r, 0):x + r + 1] = 1.0
        return pos, neg

    def points_tensor(self, max_clicks: int = 20) -> np.ndarray:
        """(max_clicks, 3) rows of (is_positive, y, x), -1 in empty
        slots."""
        pts = np.full((max_clicks, 3), -1.0, np.float32)
        for i, click in enumerate(self.clicks_list[:max_clicks]):
            pts[i] = (1.0 if click.is_positive else 0.0,
                      click.coords[0], click.coords[1])
        return pts


# -- L-BFGS with the zoom line search (optax 0.2.6) -------------------------
_F32 = np.float32
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class _Evaluator:
    """Counts the function evaluations and host syncs of one minimize."""

    def __init__(self, value_and_grad: ValueAndGrad):
        self.fn = value_and_grad
        self.evaluations = 0
        self.syncs = 0

    def __call__(self, x: torch.Tensor):
        self.evaluations += 1
        return self.fn(x)

    def fetch(self, *scalars: torch.Tensor) -> List[np.float32]:
        """0-d device tensors as host float32 scalars, in one copy."""
        self.syncs += 1
        return [_F32(v) for v in
                torch.stack(scalars).detach().cpu().numpy()]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (optax `_cubicmin`; NaN when there is none)."""
    cc = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - cc * db, fc - fa - cc * dc
    a3 = (dc * dc * v0 + (-(db * db)) * v1) / denom
    b3 = ((-(dc * (dc * dc))) * v0 + db * (db * db) * v1) / denom
    radical = b3 * b3 - _F32(3.0) * a3 * cc
    return a + (-b3 + np.sqrt(radical)) / (_F32(3.0) * a3)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax `_quadmin`)."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (_F32(2.0) * bb)


class _ZoomLinesearch:
    """optax's `zoom_linesearch` (Algorithms 3.5 and 3.6 of Nocedal and
    Wright) with `scale_by_zoom_linesearch`'s defaults. `run` returns
    (stepsize, value, grad, steps) along `updates` from `params`."""

    def __init__(self, max_steps: int = 20, tol: float = 0.0,
                 increase_factor: float = 2.0, slope_rtol: float = 1e-4,
                 curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
                 interval_threshold: float = 1e-5):
        self.max_steps = max_steps
        self.tol = tol
        self.increase_factor = increase_factor
        self.slope_rtol = slope_rtol
        self.curv_rtol = curv_rtol
        self.approx_dec_rtol = approx_dec_rtol
        self.interval_threshold = interval_threshold

    def _decrease_error(self, stepsize, value, slope, value_init,
                        slope_init):
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - (2 * self.slope_rtol - 1.0) * slope_init
        delta = value - value_init - self.approx_dec_rtol * np.abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, _F32(0.0))
        return _F32(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope, slope_init):
        err = np.maximum(np.abs(slope) - self.curv_rtol * np.abs(slope_init),
                         _F32(0.0))
        return _F32(np.inf) if np.isnan(err) else err

    def run(self, ev: _Evaluator, params: torch.Tensor,
            updates: torch.Tensor, value: np.float32, grad: torch.Tensor,
            slope: np.float32):
        tol = _F32(self.tol)
        zero = _F32(0.0)
        s = dict(count=0, stepsize=zero, value=value, grad=grad, slope=slope,
                 decrease_error=_F32(np.inf), interval_found=False,
                 done=False, failed=False, low=zero, value_low=value,
                 slope_low=slope, high=zero, value_high=value,
                 slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
                 safe_stepsize=zero, safe_value=value, safe_grad=grad)
        value_init, slope_init = value, slope

        def on_line(stepsize):
            v, g = ev(params + float(stepsize) * updates)
            v, sl = ev.fetch(v, torch.dot(g, updates))
            return v, g, sl

        def errors(stepsize, v, sl):
            dec = self._decrease_error(stepsize, v, sl, value_init,
                                       slope_init)
            curv = self._curvature_error(sl, slope_init)
            return dec, np.maximum(dec, curv)

        with np.errstate(all="ignore"):
            while not (s["done"] or s["failed"]):
                if not s["interval_found"]:
                    self._search_interval(s, on_line, errors, tol)
                else:
                    self._zoom(s, on_line, errors, tol)
                if s["failed"]:
                    # the safe step: the best stepsize with sufficient
                    # decrease, or that one outside the domain
                    if s["safe_stepsize"] > 0 or np.isinf(
                            s["decrease_error"]):
                        s.update(stepsize=s["safe_stepsize"],
                                 value=s["safe_value"], grad=s["safe_grad"])
        return s["stepsize"], s["value"], s["grad"], s["count"]

    def _search_interval(self, s, on_line, errors, tol):
        prev = (s["stepsize"], s["value"], s["slope"])
        new = (_F32(1.0) if s["count"] == 0
               else _F32(self.increase_factor) * prev[0])
        v, g, sl = on_line(new)
        dec, err = errors(new, v, sl)
        if dec <= tol:
            s.update(safe_stepsize=new, safe_value=v, safe_grad=g)
        high_to_new = (dec > 0) or (v >= prev[1] and s["count"] > 0)
        low_to_new = (sl >= 0) and not high_to_new
        if low_to_new:
            low, high = (new, v, sl), prev
        else:
            low, high = prev, (new, v, sl)
        done = bool(err <= tol)
        s.update(count=s["count"] + 1, stepsize=new, value=v, grad=g,
                 slope=sl, decrease_error=dec,
                 interval_found=bool(high_to_new or low_to_new
                                     or err <= tol),
                 done=done,
                 failed=(s["count"] + 1 >= self.max_steps) and not done,
                 low=low[0], value_low=low[1], slope_low=low[2],
                 high=high[0], value_high=high[1], slope_high=high[2],
                 cubic_ref=low[0], value_cubic_ref=low[1])

    def _zoom(self, s, on_line, errors, tol):
        low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
        high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        too_small = delta <= self.interval_threshold
        cubic = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"],
                          s["value_cubic_ref"])
        quad = _quadmin(low, vlow, slow, high, vhigh)
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        elif left + 0.1 * delta < quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / _F32(2.0)
        v, g, sl = on_line(middle)
        dec, err = errors(middle, v, sl)
        if dec <= tol and v < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=v, safe_grad=g)
        done = bool(err <= tol)
        high_to_middle = (dec > 0) or (v >= vlow)
        high_to_low = (sl * (high - low) >= 0) and not high_to_middle
        new_high = (middle, v, sl) if high_to_middle else (high, vhigh, shigh)
        if high_to_low:
            new_high = (low, vlow, slow)
        new_low = (low, vlow, slow) if high_to_middle else (middle, v, sl)
        ref = ((high, vhigh) if high_to_middle or high_to_low
               else (low, vlow))
        failed = ((s["count"] + 1 >= self.max_steps)
                  or (too_small and s["safe_stepsize"] > 0)) and not done
        s.update(count=s["count"] + 1, stepsize=middle, value=v, grad=g,
                 slope=sl, decrease_error=dec, done=done, failed=failed,
                 low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                 high=new_high[0], value_high=new_high[1],
                 slope_high=new_high[2], cubic_ref=ref[0],
                 value_cubic_ref=ref[1])


def _precondition(grad, dw, du, rho, identity_scale, memory_idx):
    """The two-loop product of optax `_precondition_by_lbfgs`: the memory
    slots from memory_idx on, walked backwards, then forwards."""
    m = rho.shape[0]
    order = [(memory_idx + j) % m for j in range(m)]
    vec, alphas = grad, {}
    for idx in reversed(order):
        alphas[idx] = rho[idx] * torch.dot(dw[idx], vec)
        vec = vec + (-alphas[idx]) * du[idx]
    vec = identity_scale * vec
    for idx in order:
        beta = rho[idx] * torch.dot(du[idx], vec)
        vec = vec + (alphas[idx] - beta) * dw[idx]
    return vec


def lbfgs_minimize(value_and_grad: ValueAndGrad, x0: torch.Tensor,
                   iterations: int, memory: int = 10
                   ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """`iterations` steps of optax.lbfgs() (the scan of the JAX package's
    BRS) from `x0`, a 1-D float32 tensor. `value_and_grad(x)` returns (0-d
    value, gradient) tensors on x's device. Returns (x, stats): stats
    counts iterations, function evaluations, line-search steps and host
    syncs."""
    ev = _Evaluator(value_and_grad)
    ls = _ZoomLinesearch()
    n, dev = x0.numel(), x0.device
    dw = torch.zeros((memory, n), dtype=torch.float32, device=dev)
    du = torch.zeros_like(dw)
    rho = torch.zeros(memory, dtype=torch.float32, device=dev)
    prev_x, prev_g = torch.zeros_like(x0), torch.zeros_like(x0)
    x, value, grad, ls_steps = x0, None, None, 0
    for count in range(iterations):
        fresh = value is None or not np.isfinite(value)
        if fresh:  # optax.value_and_grad_from_state
            value_t, grad = ev(x)
        # scale_by_lbfgs: the memory, then the preconditioned direction
        prev_idx = (count - 1) % memory
        if count > 0:
            d_x, d_g = x - prev_x, grad - prev_g
            vdot = torch.dot(d_g, d_x)
            dw[prev_idx], du[prev_idx] = d_x, d_g
            rho[prev_idx] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            den = torch.dot(d_g, d_g)
            scale = torch.where(den > 0.0, vdot / den, 1.0)
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad),
                                max=1.0)
        updates = -_precondition(grad, dw, du, rho, scale, count % memory)
        prev_x, prev_g = x, grad
        slope_t = torch.dot(updates, grad)
        if fresh:
            value, slope = ev.fetch(value_t, slope_t)
        else:
            slope, = ev.fetch(slope_t)
        step, value, grad, steps = ls.run(ev, x, updates, value, grad,
                                          slope)
        ls_steps += steps
        x = x + float(step) * updates
    return x, dict(iterations=iterations, evaluations=ev.evaluations,
                   linesearch_steps=ls_steps, syncs=ev.syncs)


class ISegAgent:
    """The JAX package's `ISegAgent` surface. `model_path` is a flax
    msgpack checkpoint (weights/iseg.msgpack) or its variables tree; None
    gives flax-like random weights from a `torch.Generator` seeded with
    `seed`. `dtype` is the net's (`models/precision.py`): float32, or
    bfloat16 convolutions with float32 BatchNorms, as JAX's `dtype=`
    builds it; the probabilities are float32 either way. `device` is the
    card unless the caller passes "cpu"."""

    def __init__(self, model_path=None, with_brs: bool = False,
                 input_long_side: int = 800, prob_thresh: float = 0.5,
                 with_flip: bool = True, cuda_device: int = 0,
                 max_clicks: int = 20, brs_reg_weight: float = 1e-3,
                 brs_reg_bias_weight: float = 10.0, brs_maxiter: int = 20,
                 insertion_mode: str = "after_aspp",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        if insertion_mode not in INSERTION_MODES:
            raise ValueError(f"unknown insertion_mode {insertion_mode!r}")
        self.device = resolve_device(device)
        self.insertion_mode = insertion_mode
        self.input_long_side = int(input_long_side)
        self.prob_thresh = float(prob_thresh)
        self.with_flip = bool(with_flip)
        self.with_brs = bool(with_brs)
        self.max_clicks = int(max_clicks)
        self.brs_reg_weight = float(brs_reg_weight)
        self.brs_reg_bias_weight = float(brs_reg_bias_weight)
        self.brs_maxiter = int(brs_maxiter)
        model = empty_module(DistMapsModel)
        if model_path is not None:
            model.load_state_dict(load_iseg(model_path))
        else:
            init_flax_like(model, torch.Generator().manual_seed(seed))
        self.model = convs_to(model.to(self.device).eval(), dtype
                              ).requires_grad_(False)
        self.brs_stats: Dict[str, int] = {}

    # -- device work ----------------------------------------------------------
    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) logits -> (H, W) probabilities, the flip's
        mirrored back and averaged."""
        probs = torch.sigmoid(logits[:, 0].float())
        if self.with_flip:
            return 0.5 * (probs[0] + probs[1].flip(-1))
        return probs[0]

    def device_predict(self, batch_img: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
        """Plain prediction: (H, W) probabilities."""
        with torch.no_grad():
            return self._probs(self.model(batch_img, points))

    def brs_objective(self, feats: torch.Tensor, aux, hw: Tuple[int, int],
                      pos_map: torch.Tensor, neg_map: torch.Tensor
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
        """x = (scale, bias) -> click-miss loss + L2 term (the JAX
        package's BRS objective)."""
        c = feats.shape[1]
        mode = self.insertion_mode

        def objective(x):
            scale, bias = x[:c], x[c:]
            probs = self._probs(self.model.logits_from_features(
                feats, hw, scale, bias, mode, aux))
            pos_diff = (1.0 - probs) * pos_map
            neg_diff = probs * neg_map
            loss = ((pos_diff ** 2).sum() / (pos_map.sum() + 1e-5)
                    + (neg_diff ** 2).sum() / (neg_map.sum() + 1e-5))
            reg = self.brs_reg_weight * (
                (scale ** 2).sum()
                + self.brs_reg_bias_weight * (bias ** 2).sum())
            return loss + reg

        return objective

    def device_predict_brs(self, batch_img: torch.Tensor,
                           hw: Tuple[int, int], points: torch.Tensor,
                           pos_map: torch.Tensor,
                           neg_map: torch.Tensor) -> torch.Tensor:
        """BRS prediction: (scale, bias) at the insertion point found by
        `brs_maxiter` L-BFGS steps from 0, then the (H, W) probabilities
        they give."""
        mode = self.insertion_mode
        with torch.no_grad():
            feats, aux = self.model.features(batch_img, points, mode)
        c = feats.shape[1]
        objective = self.brs_objective(feats, aux, hw, pos_map, neg_map)

        def value_and_grad(x):
            with torch.enable_grad():
                x = x.detach().requires_grad_(True)
                value = objective(x)
                grad, = torch.autograd.grad(value, x)
            return value.detach(), grad

        x0 = torch.zeros(2 * c, dtype=torch.float32, device=feats.device)
        x, self.brs_stats = lbfgs_minimize(value_and_grad, x0,
                                           self.brs_maxiter)
        with torch.no_grad():
            return self._probs(self.model.logits_from_features(
                feats, hw, x[:c], x[c:], mode, aux))

    # -- host API ---------------------------------------------------------------
    def forward(self, img: np.ndarray, click_history) -> np.ndarray:
        """img BGR uint8 + [(is_positive, y, x), ...] -> mask {0, 255}."""
        probs = self.predict_probs(img, click_history)
        return (probs > self.prob_thresh).astype(np.uint8) * 255

    def predict_probs(self, img: np.ndarray, click_history,
                      use_brs: Optional[bool] = None) -> np.ndarray:
        """Foreground probabilities at the input's resolution. `use_brs`
        overrides the agent's `with_brs`."""
        if use_brs is None:
            use_brs = self.with_brs
        ori_hw = img.shape[:2]
        input_hw = get_target_size(*ori_hw, self.input_long_side)
        # the resize ratio of pad_resize
        ratio = (float(input_hw[0]) / ori_hw[0]
                 if ori_hw[0] / ori_hw[1] > input_hw[0] / input_hw[1]
                 else float(input_hw[1]) / ori_hw[1])
        norm = imnormalize(pad_resize(as_float(img, self.device), input_hw))
        clicker = Clicker(input_hw)
        for rec in click_history:
            clicker.add_click(bool(rec[0]), int(rec[1] * ratio),
                              int(rec[2] * ratio))
        pts = clicker.points_tensor(self.max_clicks)
        norm = norm.permute(2, 0, 1)
        if self.with_flip:
            batch = torch.stack([norm, norm.flip(-1)])
            pts_flipped = pts.copy()
            valid = pts_flipped[:, 1] >= 0
            pts_flipped[valid, 2] = input_hw[1] - 1 - pts_flipped[valid, 2]
            points = np.stack([pts, pts_flipped])
        else:
            batch = norm[None]
            points = pts[None]
        points = as_float(points, self.device)
        if use_brs and len(click_history) > 0:
            pos_map, neg_map = clicker.get_clicks_maps()
            probs = self.device_predict_brs(
                batch.contiguous(), input_hw, points,
                as_float(pos_map, self.device),
                as_float(neg_map, self.device))
        else:
            probs = self.device_predict(batch.contiguous(), points)
        return inv_pad_resize(probs, ori_hw).cpu().numpy()
