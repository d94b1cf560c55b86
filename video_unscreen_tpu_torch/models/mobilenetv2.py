"""MobileNetV2 backbone with dilation, for the DeepLab family.

Port of `video_unscreen_tpu/models/mobilenetv2.py` (`InvertedResidual`,
`MobileNetV2Backbone`), NCHW, inference only. Inverted-residual blocks
with dilated depthwise 3x3 convolutions (`groups` = channels); once the
output stride is reached a stage's stride becomes dilation. The backbone
returns the 24-channel feature after its second stage (stride 4) and the
320-channel feature at the output stride.

Submodules keep flax's creation order, so `utils/checkpoint.py` maps a
flax tree by name: a block's convolutions are `convs.0, ...` and its
BatchNorms `bns.0, ...` (flax `Conv_0`, `BatchNorm_0`), the backbone's
blocks one flat `irs` list (`InvertedResidual_0, ...`), its stem conv and
BN `convs.0` and `bns.0`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import FlaxBatchNorm2d

# (expansion t, channels c, repeats n, stride s): the standard table
CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class InvertedResidual(nn.Module):
    """1x1 expansion (unless `expand` is 1), BN, ReLU6; the depthwise 3x3
    (stride, dilation), BN, ReLU6; the 1x1 projection and BN; the input
    added where stride is 1 and the channels match."""

    def __init__(self, cin: int, out_ch: int, stride: int, expand: int,
                 dilation: int = 1):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == out_ch
        convs = []
        if expand != 1:
            convs.append(nn.Conv2d(cin, hidden, 1, bias=False))
        convs.append(nn.Conv2d(hidden, hidden, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               groups=hidden, bias=False))
        convs.append(nn.Conv2d(hidden, out_ch, 1, bias=False))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(FlaxBatchNorm2d(c.out_channels)
                                 for c in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for conv, bn in zip(self.convs[:-1], self.bns[:-1]):
            out = F.relu6(bn(conv(out)))
        out = self.bns[-1](self.convs[-1](out))
        return x + out if self.use_res else out


class MobileNetV2Backbone(nn.Module):
    """(N, 3, H, W) -> (low-level 24 channels at 1/4, high-level 320
    channels at 1/output_stride)."""

    def __init__(self, output_stride: int = 8, in_channels: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(in_channels, 32, 3, stride=2,
                                              padding=1, bias=False)])
        self.bns = nn.ModuleList([FlaxBatchNorm2d(32)])
        blocks, cin = [], 32
        current_stride, dilation = 2, 1
        self.low_level_end = 0
        for stage, (t, c, n, s) in enumerate(CFG):
            for i in range(n):
                stride = s if i == 0 else 1
                if stride > 1 and current_stride >= output_stride:
                    dilation *= stride
                    stride = 1
                if stride > 1:
                    current_stride *= stride
                blocks.append(InvertedResidual(cin, c, stride, t, dilation))
                cin = c
            if stage == 1:  # after the 24-channel stage
                self.low_level_end = len(blocks)
        self.irs = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu6(self.bns[0](self.convs[0](x)))
        low = None
        for i, block in enumerate(self.irs):
            x = block(x)
            if i + 1 == self.low_level_end:
                low = x
        return low, x
