"""BatchNorm with flax's training semantics.

flax `nn.BatchNorm` (the JAX package builds it without a momentum) keeps
its running statistics as ra <- 0.99 ra + 0.01 batch, with the biased
batch variance, and normalizes a training batch with that same biased
variance. torch's `nn.BatchNorm2d` defaults to ra <- 0.9 ra + 0.1 batch
with the unbiased variance. `FlaxBatchNorm2d` keeps torch's parameter and
buffer names (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`), so the checkpoint mappings of
`utils/checkpoint.py` stay as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn

FLAX_MOMENTUM = 0.99   # flax's default: the weight of the old statistic


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (NCHW) that trains as flax's `nn.BatchNorm` does.

    Eval mode is `nn.BatchNorm2d`'s own forward on the running statistics,
    unchanged. Train mode computes the batch statistics as flax does by
    default (`use_fast_variance=True`): mean = E[x], var = max(E[x^2] -
    E[x]^2, 0) over N, H and W, in at least float32 (flax's
    `force_float32_reductions`: bfloat16 is promoted), and normalizes with them as (x - mean) *
    (rsqrt(var + eps) * weight) + bias in that type, returned in x's dtype;
    the gradient flows through both statistics. It then updates running_mean and running_var
    with momentum 0.99 and that biased variance. The one-pass variance
    loses digits where |mean| >> std, exactly as the reference does; the
    port keeps it so its statistics agree with flax's to f32 rounding
    (reductions taken in another order), not to the error of a different
    formula.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1 - FLAX_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(FLAX_MOMENTUM).add_(
                mean, alpha=1 - FLAX_MOMENTUM)
            self.running_var.mul_(FLAX_MOMENTUM).add_(
                var, alpha=1 - FLAX_MOMENTUM)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None]).to(x.dtype)
