"""Torch modules of the port."""

from .matting_unet import MattingUNet

__all__ = ["MattingUNet"]
