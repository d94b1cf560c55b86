"""Module dtypes as the JAX package's `dtype=` sets them, and flax-like
construction.

A flax module built with `dtype=jnp.bfloat16` casts each convolution's
input and kernel to bfloat16 and returns bfloat16, while its parameters
stay float32; its BatchNorm normalizes in float32 and returns the module's
dtype. `convs_to` gives a torch module that behaviour once, at
construction: the convolution weights (and biases) become `dtype`, the
BatchNorm parameters and statistics stay float32 (torch's batch norm takes
a bfloat16 input beside float32 parameters and returns bfloat16). The nets
cast their input to their first convolution's dtype. float32 leaves a
module as it is.

`net_input` puts a seed net's input in its dtype and memory layout:
contiguous NCHW in float32 and channels-last in bfloat16. On an H100,
cuDNN runs float32 dilated convolutions many times slower channels-last,
and the bfloat16 trunk faster (`tools/profile_torch_seed.py`).

`empty_module` builds a module without drawing from the global random
number generator (on the meta device, then uninitialized storage on the
host); the caller fills every parameter and buffer, from a checkpoint or
from `parallel/train_stm.py:init_flax_like` with its own generator.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

_CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def convs_to(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the convolutions of `model` to `dtype` in place; returns it."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dtype}: float32 or bfloat16")
    for mod in model.modules():
        if isinstance(mod, _CONVS):
            mod.to(dtype)
    return model


def net_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in a seed net's dtype and memory layout (the module docstring)."""
    fmt = (torch.channels_last if dtype == torch.bfloat16
           else torch.contiguous_format)
    return x.to(dtype=dtype, memory_format=fmt)


def empty_module(build: Callable[[], nn.Module]) -> nn.Module:
    """`build()` on the host with uninitialized parameters and buffers."""
    with torch.device("meta"):
        model = build()
    return model.to_empty(device="cpu")
