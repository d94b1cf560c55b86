"""Torch modules of the port."""

from .matting_unet import MattingUNet
from .resnet import ResNet
from .stm import STM

__all__ = ["MattingUNet", "ResNet", "STM"]
