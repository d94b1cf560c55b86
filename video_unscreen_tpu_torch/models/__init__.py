"""Torch modules of the port."""

from .matting_unet import MattingUNet
from .resnet import BasicBlock, Bottleneck, ResNet
from .deeplab import DeepLabV3Plus, build_deeplab
from .human_parse import SCHPHumanParser
from .stm import STM
from .iseg import DistMapsModel

__all__ = ["MattingUNet", "ResNet", "BasicBlock", "Bottleneck",
           "DeepLabV3Plus", "build_deeplab", "SCHPHumanParser", "STM",
           "DistMapsModel"]
