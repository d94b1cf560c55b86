"""ResNet trunk: one configurable backbone for the STM encoders (and the
DeepLab and SCHP seeds of a later slice).

Port of `video_unscreen_tpu/models/resnet.py` (`BasicBlock`, `Bottleneck`,
`ResNet`), NCHW. Every submodule keeps flax's creation order: a block's
convolutions are `convs.0, convs.1, ...` and its BatchNorms `bns.0, ...`
in the order flax names them `Conv_0, BatchNorm_0, ...`, and the trunk's
blocks are one flat `blocks` list (`Bottleneck_0, Bottleneck_1, ...`), so
`utils/checkpoint.py` maps a flax tree by order. BatchNorm is
`batchnorm.FlaxBatchNorm2d` (flax's eps 1e-5, momentum and variance);
inference uses the running statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import FlaxBatchNorm2d


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_projection: bool = False):
        super().__init__()
        convs = [_conv(cin, planes, 3, stride, dilation, dilation),
                 _conv(planes, planes, 3, 1, dilation, dilation)]
        if use_projection:
            convs.append(_conv(cin, planes, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(FlaxBatchNorm2d(planes)
                                 for _ in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bns[0](self.convs[0](x)))
        out = self.bns[1](self.convs[1](out))
        identity = self.bns[2](self.convs[2](x)) if len(self.convs) > 2 \
            else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_projection: bool = False):
        super().__init__()
        out_ch = planes * 4
        convs = [_conv(cin, planes, 1),
                 _conv(planes, planes, 3, stride, dilation, dilation),
                 _conv(planes, out_ch, 1)]
        if use_projection:
            convs.append(_conv(cin, out_ch, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(FlaxBatchNorm2d(c.out_channels)
                                 for c in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bns[0](self.convs[0](x)))
        out = F.relu(self.bns[1](self.convs[1](out)))
        out = self.bns[2](self.convs[2](out))
        identity = self.bns[3](self.convs[3](x)) if len(self.convs) > 3 \
            else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Configurable trunk.

    Args:
      block: "basic" | "bottleneck".
      layers: blocks per stage, e.g. (3, 4, 6, 3) for resnet50.
      stem: "basic" (7x7 s2 conv) or "deep" (three 3x3 convs).
      replace_stride_with_dilation: per-stage-2..4 flags; a True stage keeps
        stride 1 and doubles the dilation (torchvision semantics).
      in_channels: channels of the input image.
    `forward` returns a dict of NCHW features: stem, c1 (after stage 1) ..
    c{num_stages}.
    """

    def __init__(self, block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 6, 3), stem: str = "basic",
                 replace_stride_with_dilation: Sequence[bool] = (
                     False, False, False),
                 width: int = 64, num_stages: int = 4, in_channels: int = 3):
        super().__init__()
        self.stem = stem
        block_cls = BasicBlock if block == "basic" else Bottleneck
        if stem == "deep":
            chans = (width, width, width * 2)
            strides = (2, 1, 1)
            cin = in_channels
            for i, (ch, s) in enumerate(zip(chans, strides)):
                setattr(self, f"stem_conv{i + 1}", _conv(cin, ch, 3, s, 1, 1))
                setattr(self, f"stem_bn{i + 1}", FlaxBatchNorm2d(ch))
                cin = ch
        else:
            self.stem_conv1 = _conv(in_channels, width, 7, 2, 1, 3)
            self.stem_bn1 = FlaxBatchNorm2d(width)
            cin = width
        blocks = []
        self.stage_ends = []
        dilation, planes = 1, width
        for stage in range(num_stages):
            stride = 1 if stage == 0 else 2
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            out_ch = planes * block_cls.expansion
            blocks.append(block_cls(cin, planes, stride, dilation,
                                    use_projection=(stride != 1
                                                    or cin != out_ch)))
            cin = out_ch
            for _ in range(1, layers[stage]):
                blocks.append(block_cls(cin, planes, 1, dilation))
            self.stage_ends.append(len(blocks))
            planes *= 2
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor,
                stem_extra: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """`stem_extra`, if given, is added to the first stem conv's output
        before its BN (the STM memory encoder injects its mask features so;
        basic stem only)."""
        if self.stem == "deep":
            for i in range(1, 4):
                x = getattr(self, f"stem_conv{i}")(x)
                x = F.relu(getattr(self, f"stem_bn{i}")(x))
        else:
            x = self.stem_conv1(x)
            if stem_extra is not None:
                x = x + stem_extra
            x = F.relu(self.stem_bn1(x))
        feats = {"stem": x}
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        start = 0
        for stage, end in enumerate(self.stage_ends):
            for blk in self.blocks[start:end]:
                x = blk(x)
            feats[f"c{stage + 1}"] = x
            start = end
        return feats
