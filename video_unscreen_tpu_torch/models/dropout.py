"""Dropout with flax's semantics, drawing from an explicit generator.

flax `nn.Dropout(rate, deterministic=not train)` is the identity in eval
mode and at rate 0; in train mode it keeps each element with probability
1 - rate and scales the kept ones by 1 / (1 - rate):
`where(keep, x / (1 - rate), 0)`. `FlaxDropout` does the same in torch
train mode. Its mask comes from `torch.rand` on `generator` (a
`torch.Generator` on the input's device that the train step owns and
seeds, `attach_generator`), or from torch's default generator when none
is attached. The JAX train steps draw their masks from
`fold_in(PRNGKey(17 or 23), step)`; no torch generator reproduces that
stream, so a port run and a JAX run drop different elements (the tests
hold both with the rate at 0, and the port's masks to their own seed).

Over ranks, a dropout given its data block (`data_block`: (this rank's
index, the data axis' size), (0, 1) in one process, set by
`parallel/tensor_parallel.py:sync_data_axis`) draws the whole batch's
mask, every rank alike from the step's generator, and keeps its own block
of it: the masks are those of one process stepping the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


class FlaxDropout(nn.Module):
    """`nn.Dropout(rate)` of flax: identity unless training and rate > 0."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.data_block: Tuple[int, int] = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        index, n = self.data_block
        b = x.shape[0]
        u = torch.rand((n * b,) + tuple(x.shape[1:]), generator=self.generator,
                       device=x.device)[index * b:(index + 1) * b]
        return torch.where(u < keep_prob, x / keep_prob,
                           torch.zeros((), dtype=x.dtype, device=x.device))


def dropouts(model: nn.Module):
    """The model's `FlaxDropout` modules, in module order."""
    return [m for m in model.modules() if isinstance(m, FlaxDropout)]


def attach_generator(model: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Let every `FlaxDropout` of `model` draw from `generator`."""
    for m in dropouts(model):
        m.generator = generator
