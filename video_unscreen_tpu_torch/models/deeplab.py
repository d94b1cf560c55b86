"""DeepLabV3 / V3+ segmentation nets on the dilated ResNet trunk.

Port of `video_unscreen_tpu/models/deeplab.py` (`ASPPConv`, `ASPP`,
`DeepLabV3Plus`, `DeepLabV3`, `DeepLabV3PlusMobileNet`, `build_deeplab`),
NCHW. In eval mode, which every inference path uses, BatchNorm runs on
its running statistics and the ASPP's dropout is the identity; in train
mode (`parallel/train_seg.py`, and `parallel/train_iseg.py` through the
ISeg's ASPP) BatchNorm takes the batch statistics and the ASPP output
goes through flax's `Dropout(0.1)` (`models/dropout.py`: kept elements
scaled by 1 / 0.9, the mask from the train step's generator). The seed
the green path ships is deeplabv3plus_resnet50 at output stride 8, ASPP
dilations (12, 24, 36), 2 classes.

Submodules carry flax's names, so `utils/checkpoint.py:load_deeplab` maps
a checkpoint one to one: explicit names (`backbone`, `aspp`,
`project_conv`, `cls_out`, ...) stay, flax's auto-names become lists in
creation order (`ASPPConv_1` -> `branches.1`, `Conv_2` -> `convs.2`,
`BatchNorm_0` -> `bns.0`).

Both of the model's "linear" `jax.image.resize` calls upsample (the ASPP
output onto the low-level grid, the logits onto the input), where flax's
default antialiasing changes nothing: they are
`ops/geometry.py:resize_nchw` (bilinear, half-pixel centres).

The net runs in the dtype of its convolution weights (`models/precision.py`:
float32, or bfloat16 convolutions beside float32 BatchNorm parameters);
the logits come out in that dtype. Its input goes in channels-last memory
in bfloat16 and in contiguous NCHW in float32: on an H100, cuDNN runs the
float32 dilated ASPP convolutions many times slower channels-last, and
the bfloat16 trunk faster (`tools/profile_torch_seed.py` times the parts
as the net runs them).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import resize_nchw
from .batchnorm import FlaxBatchNorm2d
from .dropout import FlaxDropout
from .mobilenetv2 import MobileNetV2Backbone
from .precision import net_input
from .resnet import ResNet


def _conv(cin: int, cout: int, k: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


class ASPPConv(nn.Module):
    """3x3 atrous conv, BN, ReLU (flax `ASPPConv`: Conv_0, BatchNorm_0)."""

    def __init__(self, cin: int, dilation: int, channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([_conv(cin, channels, 3, dilation)])
        self.bns = nn.ModuleList([FlaxBatchNorm2d(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bns[0](self.convs[0](x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one ASPPConv per
    dilation and the image-pooling branch (spatial mean, 1x1 conv and BN on
    the 1x1 map, broadcast back), concatenated and projected by a 1x1
    conv, then dropout (train mode only). flax creates Conv_0 (the 1x1
    branch), the ASPPConvs, Conv_1 (the pooling branch) and Conv_2 (the
    projection) in that order."""

    def __init__(self, cin: int, dilations: Sequence[int] = (12, 24, 36),
                 channels: int = 256):
        super().__init__()
        n_branches = 2 + len(dilations)
        self.convs = nn.ModuleList([_conv(cin, channels), _conv(cin, channels),
                                    _conv(n_branches * channels, channels)])
        self.bns = nn.ModuleList(FlaxBatchNorm2d(channels) for _ in range(3))
        self.branches = nn.ModuleList(ASPPConv(cin, d, channels)
                                      for d in dilations)
        self.dropout = FlaxDropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        outs = [F.relu(self.bns[0](self.convs[0](x)))]
        outs += [b(x) for b in self.branches]
        pooled = x.mean(dim=(2, 3), keepdim=True)
        pooled = F.relu(self.bns[1](self.convs[1](pooled)))
        outs.append(pooled.expand(n, pooled.shape[1], h, w))
        out = F.relu(self.bns[2](self.convs[2](torch.cat(outs, dim=1))))
        return self.dropout(out)


def _dilation(output_stride: int):
    return (False, True, True) if output_stride == 8 else (False, False, True)


class DeepLabV3Plus(nn.Module):
    """DeepLabV3+ over a dilated ResNet: the stage-1 features projected to
    48 channels, the ASPP output upsampled onto their grid, concatenated
    (304 channels) and classified; logits resized to the input. (N, 3, H,
    W) normalized RGB -> (N, num_classes, H, W)."""

    def __init__(self, num_classes: int = 2,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 8,
                 aspp_dilations: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.backbone = ResNet("bottleneck", backbone_layers,
                               replace_stride_with_dilation=_dilation(
                                   output_stride))
        self.project_conv = _conv(256, 48)
        self.project_bn = FlaxBatchNorm2d(48)
        self.aspp = ASPP(2048, aspp_dilations)
        self.cls_conv = _conv(48 + 256, 256, 3)
        self.cls_bn = FlaxBatchNorm2d(256)
        self.cls_out = nn.Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[-2:]
        feats = self.backbone(net_input(x, self.cls_out.weight.dtype))
        low = F.relu(self.project_bn(self.project_conv(feats["c1"])))
        out = resize_nchw(self.aspp(feats["c4"]), low.shape[-2:])
        out = F.relu(self.cls_bn(self.cls_conv(torch.cat([low, out], dim=1))))
        return resize_nchw(self.cls_out(out), in_hw)


class DeepLabV3(nn.Module):
    """Plain DeepLabV3: ASPP, a 3x3 conv and the classifier over the
    stage-4 features, without the low-level skip."""

    def __init__(self, num_classes: int = 2,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 8,
                 aspp_dilations: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.backbone = ResNet("bottleneck", backbone_layers,
                               replace_stride_with_dilation=_dilation(
                                   output_stride))
        self.aspp = ASPP(2048, aspp_dilations)
        self.cls_conv = _conv(256, 256, 3)
        self.cls_bn = FlaxBatchNorm2d(256)
        self.cls_out = nn.Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[-2:]
        feats = self.backbone(net_input(x, self.cls_out.weight.dtype))
        out = self.aspp(feats["c4"])
        out = F.relu(self.cls_bn(self.cls_conv(out)))
        return resize_nchw(self.cls_out(out), in_hw)


class DeepLabV3PlusMobileNet(nn.Module):
    """deeplabv3plus_mobilenet: the MobileNetV2 backbone's 24-channel
    low-level feature projected to 48 channels, the ASPP at its
    320-channel high-level feature, then the V3+ head as in
    `DeepLabV3Plus`."""

    def __init__(self, num_classes: int = 2, output_stride: int = 8,
                 aspp_dilations: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.backbone = MobileNetV2Backbone(output_stride)
        self.project_conv = _conv(24, 48)
        self.project_bn = FlaxBatchNorm2d(48)
        self.aspp = ASPP(320, aspp_dilations)
        self.cls_conv = _conv(48 + 256, 256, 3)
        self.cls_bn = FlaxBatchNorm2d(256)
        self.cls_out = nn.Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[-2:]
        low, out = self.backbone(net_input(x, self.cls_out.weight.dtype))
        low = F.relu(self.project_bn(self.project_conv(low)))
        out = resize_nchw(self.aspp(out), low.shape[-2:])
        out = F.relu(self.cls_bn(self.cls_conv(torch.cat([low, out], dim=1))))
        return resize_nchw(self.cls_out(out), in_hw)


def build_deeplab(num_classes: int = 2, variant: str = "resnet50",
                  output_stride: int = 8, plus: bool = True) -> nn.Module:
    """deeplabv3{,plus} over resnet50 or resnet101, and deeplabv3plus over
    mobilenet (MobileNetV2)."""
    if variant == "mobilenet":
        if not plus:
            raise ValueError("the MobileNetV2 variant has the V3+ head only")
        return DeepLabV3PlusMobileNet(num_classes=num_classes,
                                      output_stride=output_stride)
    layers = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}[variant]
    cls = DeepLabV3Plus if plus else DeepLabV3
    return cls(num_classes=num_classes, backbone_layers=layers,
               output_stride=output_stride)
