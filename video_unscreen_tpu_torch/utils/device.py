"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on.

    "cuda" (the entry points' default) requires a card: without one this
    raises instead of quietly running on the host; pass "cpu" for the host.
    On a card both TF32 switches are turned off: the green path is float32
    and is held to the float32 JAX reference and to its own CPU run, while
    TF32 keeps about three decimal digits (cuDNN's float32 convolutions use
    it by default)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for, but CUDA is not "
                "available; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: 'cuda' or 'cpu'")
    return dev
