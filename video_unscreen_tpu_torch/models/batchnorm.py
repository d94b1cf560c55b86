"""BatchNorm with flax's training semantics.

flax `nn.BatchNorm` (the JAX package builds it without a momentum) keeps
its running statistics as ra <- 0.99 ra + 0.01 batch, with the biased
batch variance, and normalizes a training batch with that same biased
variance. torch's `nn.BatchNorm2d` defaults to ra <- 0.9 ra + 0.1 batch
with the unbiased variance. `FlaxBatchNorm2d` keeps torch's parameter and
buffer names (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`), so the checkpoint mappings of
`utils/checkpoint.py` stay as they are.

Over ranks (`parallel/train.py`'s step on a mesh), a module given the
data axis' sum (`data_sum`, a differentiable sum over the ranks, and
`data_ranks`, their number, both set by
`parallel/tensor_parallel.py:sync_data_axis`) takes its statistics over
the whole batch, as JAX's step, one program over the mesh, does; plain
per-rank statistics, as in DDP, would not be JAX's. A tensor-parallel
module (`tensor_parallel.ShardedBatchNorm2d`) gathers its split scale and
bias in `scale_bias`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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

    With `data_sum` set, the sums of x and x^2 over N, H and W are summed
    over the ranks of the data axis by it (a differentiable `all_reduce`,
    whose backward sums the gradients too), in the same type, and divided
    by the whole batch's count (this rank's times `data_ranks`: the batch
    splits in equal blocks); every rank then updates the running
    statistics alike.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1 - FLAX_MOMENTUM)
        self.data_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self.data_ranks = 1

    def scale_bias(self):
        """(scale, bias) as the forward uses them."""
        return self.weight, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.scale_bias()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, self.momentum, self.eps)
        dims = (0, 2, 3)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.data_sum is None:
            mean = xf.mean(dim=dims)
            ex2 = (xf * xf).mean(dim=dims)
        else:
            count = xf.numel() // xf.shape[1] * self.data_ranks
            sums = self.data_sum(torch.stack([xf.sum(dim=dims),
                                              (xf * xf).sum(dim=dims)]))
            mean, ex2 = sums[0] / count, sums[1] / count
        var = torch.clamp_min(ex2 - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(FLAX_MOMENTUM).add_(
                mean, alpha=1 - FLAX_MOMENTUM)
            self.running_var.mul_(FLAX_MOMENTUM).add_(
                var, alpha=1 - FLAX_MOMENTUM)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * weight
        return ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
                + bias[None, :, None, None]).to(x.dtype)
