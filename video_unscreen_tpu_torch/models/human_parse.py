"""SCHP human parser (LIP, 20 classes): bg mode's seed segmenter.

Port of `video_unscreen_tpu/models/human_parse.py`, NCHW, inference only
(BatchNorm on its running statistics, dropout the identity): a deep stem
(three 3x3 convolutions, BN and ReLU, then a 3x3/2 max-pool), the dilated
ResNet-101 stages on `models/resnet.py:Bottleneck` (layer4 at stride 1,
dilation 2: output stride 16), the PSP context module, the edge branch
over the stage 1-3 features, the parsing decoder and the fusion head. The
logits come out at 1/4 of the input, in float32.

The edge and parsing heads' own logits (the edge module's `conv4`,
`conv5` and the decoder's last convolution) do not reach the fusion
logits; their parameters are kept so a checkpoint loads whole, but the
forward does not compute them.

Every "linear" `jax.image.resize` of the model (`_resize_to`) upsamples at
the shipped crop (473: PSP's 1..6 bins onto a 30x30 map, the 1/8 and 1/16
maps onto the 1/4 one), where flax's default antialiasing changes nothing:
it is `ops/geometry.py:resize_nchw`. A map smaller than PSP's 6 bins
(crops under ~81 pixels) would be downsampled; that goes through torch's
antialiased bilinear filter, which agrees with JAX's antialiased linear
kernel (`tests/test_torch_human_parse.py`).

Submodules carry flax's names for `utils/checkpoint.py:load_schp`:
explicit names (`stem_conv1`, `layer3_17`, `psp`, `edge`, `conv4`,
`fusion_out`, ...) stay, auto-names become lists in creation order
(`Conv_2` -> `convs.2`, `_ABN_1` -> `abns.1`, `BatchNorm_0` -> `bns.0`).
The net runs in its convolutions' dtype (`models/precision.py`), its input
in `net_input`'s layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import resize_nchw
from .batchnorm import FlaxBatchNorm2d
from .precision import net_input
from .resnet import Bottleneck


def _conv(cin: int, cout: int, k: int = 1, bias: bool = False,
          stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=bias)


class _ABN(nn.Module):
    """BN + LeakyReLU(0.01) (flax `_ABN`: BatchNorm_0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bns = nn.ModuleList([FlaxBatchNorm2d(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bns[0](x), 0.01)


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` with its default antialiasing
    (the module docstring)."""
    if x.shape[-2] <= h and x.shape[-1] <= w:
        return resize_nchw(x, (h, w))
    return F.interpolate(x.float(), size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True).to(x.dtype)


class PSPModule(nn.Module):
    """Pyramid pooling: adaptive average pools (PyTorch's bins, as the JAX
    package's `_adaptive_avg_pool`), 1x1 conv and ABN each, upsampled and
    concatenated with the input, then a 3x3 conv and ABN."""

    def __init__(self, cin: int = 2048, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        n = len(self.sizes)
        self.convs = nn.ModuleList(
            [_conv(cin, out_features) for _ in self.sizes]
            + [_conv(cin + n * out_features, out_features, 3)])
        self.abns = nn.ModuleList(_ABN(out_features) for _ in range(n + 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        priors = [_resize_to(self.abns[i](self.convs[i](
            F.adaptive_avg_pool2d(x, size))), h, w)
            for i, size in enumerate(self.sizes)]
        out = torch.cat(priors + [x], dim=1)
        return self.abns[-1](self.convs[-1](out))


class EdgeModule(nn.Module):
    """Edge branch over the stage 1-3 features; `forward` returns the edge
    features (3 x 256 channels at the first map's size)."""

    def __init__(self, cins: Sequence[int] = (256, 512, 1024),
                 mid_fea: int = 256, out_fea: int = 2):
        super().__init__()
        for i, cin in enumerate(cins):
            setattr(self, f"conv{i + 1}", _conv(cin, mid_fea))
        self.conv4 = _conv(mid_fea, out_fea, 3, bias=True)
        self.conv5 = _conv(len(cins) * out_fea, out_fea, bias=True)
        self.abns = nn.ModuleList(_ABN(mid_fea) for _ in cins)

    def forward(self, x1, x2, x3) -> torch.Tensor:
        h, w = x1.shape[-2:]
        feas = [self.abns[i](getattr(self, f"conv{i + 1}")(x))
                for i, x in enumerate((x1, x2, x3))]
        return torch.cat([feas[0]] + [_resize_to(f, h, w)
                                      for f in feas[1:]], dim=1)


class DecoderModule(nn.Module):
    """Parsing decoder; `forward` returns its 256-channel features."""

    def __init__(self, cin_t: int = 512, cin_l: int = 256,
                 num_classes: int = 20):
        super().__init__()
        self.convs = nn.ModuleList([
            _conv(cin_t, 256), _conv(cin_l, 48), _conv(304, 256),
            _conv(256, 256), _conv(256, num_classes, bias=True)])
        self.abns = nn.ModuleList(_ABN(c) for c in (256, 48, 256, 256))

    def forward(self, xt: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
        h, w = xl.shape[-2:]
        xt = _resize_to(self.abns[0](self.convs[0](xt)), h, w)
        xl = self.abns[1](self.convs[1](xl))
        x = self.abns[2](self.convs[2](torch.cat([xt, xl], dim=1)))
        return self.abns[3](self.convs[3](x))


class SCHPHumanParser(nn.Module):
    """(N, 3, H, W) normalized RGB -> (N, num_classes, h, w) float32
    fusion logits at 1/4 of the input (the stem's and the pool's strides:
    119x119 at 473x473)."""

    def __init__(self, num_classes: int = 20,
                 layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        cin = 3
        for i, ch in enumerate((64, 64, 128)):
            setattr(self, f"stem_conv{i + 1}",
                    _conv(cin, ch, 3, stride=2 if i == 0 else 1))
            setattr(self, f"stem_bn{i + 1}", FlaxBatchNorm2d(ch))
            cin = ch
        self.stages = []
        for s, (planes, stride, dilation) in enumerate(
                ((64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 1, 2))):
            names = []
            for b in range(layers[s]):
                proj = b == 0 and (stride != 1 or cin != planes * 4)
                setattr(self, f"layer{s + 1}_{b}", Bottleneck(
                    cin, planes, stride if b == 0 else 1, dilation,
                    use_projection=proj))
                names.append(f"layer{s + 1}_{b}")
                cin = planes * 4
            self.stages.append(names)
        self.psp = PSPModule(cin)
        self.decoder = DecoderModule(num_classes=num_classes)
        self.edge = EdgeModule()
        self.fusion_conv1 = _conv(1024, 256)
        self.abns = nn.ModuleList([_ABN(256)])
        self.fusion_out = _conv(256, num_classes, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.heads(*self.trunk(
            net_input(x, self.fusion_out.weight.dtype)))

    def trunk(self, x: torch.Tensor):
        """The stem and the four stages: their outputs (1/4, 1/8, 1/16,
        1/16 of the input)."""
        for i in range(1, 4):
            x = getattr(self, f"stem_conv{i}")(x)
            x = F.relu(getattr(self, f"stem_bn{i}")(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats

    def heads(self, x2, x3, x4, x5) -> torch.Tensor:
        """PSP, the parsing decoder, the edge branch and the fusion head
        on the stage outputs: the float32 fusion logits."""
        parsing_fea = self.decoder(self.psp(x5), x2)
        edge_fea = self.edge(x2, x3, x4)
        fused = self.fusion_conv1(torch.cat([parsing_fea, edge_fea], dim=1))
        return self.fusion_out(self.abns[0](fused)).float()
