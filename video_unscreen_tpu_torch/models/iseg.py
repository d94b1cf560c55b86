"""Interactive-segmentation model: DistMaps + DeepLabV3+ + SepConvHead.

Port of `video_unscreen_tpu/models/iseg.py` (`dist_maps`, `SepConvHead`,
`BRSDeepLabV3Plus`, `DistMapsModel`), NCHW; eval mode for inference and
BRS, train mode (`parallel/train_iseg.py`) with BatchNorm's batch
statistics and the ASPP's dropout (`models/deeplab.py`). Clicks become
min-distance tanh(2 sqrt(d^2)) maps, fused with the RGB input by a 1x1
conv block, fed to a DeepLabV3+ variant (ResNet-50 trunk without
dilation, the stage-1 skip projected to 32 channels, ASPP with 128
channels at the stage-4 feature) and classified by depthwise-separable
heads.

Clicks are a fixed-size (B, N, 3) tensor of (is_positive, y, x) rows,
y < 0 marking an empty slot. `features(..., insertion_mode)` stops at a
BRS insertion point and `logits_from_features` finishes from it, with the
per-channel perturbation feats * (1 + scale) + bias: "after_aspp" (the
160-channel ASPP + skip concat), "after_c4" (the trunk's output; the ASPP
re-runs) or "after_deeplab" (after the DeepLab head).

The two "linear" `jax.image.resize` calls upsample (the ASPP output onto
the skip's grid, the logits onto the input), where flax's antialiasing
changes nothing: both are `ops/geometry.py:resize_nchw`. Submodules carry
flax's names (`rgb_conv1`, `feature_extractor.aspp`, `inst_head.convs.4`,
...), so `utils/checkpoint.py:load_iseg` maps a checkpoint one to one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import resize_nchw
from .batchnorm import FlaxBatchNorm2d
from .deeplab import ASPP
from .resnet import ResNet

INSERTION_MODES = ("after_aspp", "after_c4", "after_deeplab")


def nearest_sq_dist(points: torch.Tensor, h: int, w: int,
                    norm_radius: float = 260.0) -> torch.Tensor:
    """(B, N, 3) clicks -> (B, 2, H, W): the squared distance, in units of
    `norm_radius`, to the nearest valid positive and negative click (1e6
    where there is none)."""
    dev = points.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    is_pos = (points[..., 0] > 0.5)[..., None, None]      # (B, N, 1, 1)
    valid = (points[..., 1] >= 0)[..., None, None]
    dy = (ys - points[..., 1, None, None]) / norm_radius  # (B, N, H, 1)
    dx = (xs - points[..., 2, None, None]) / norm_radius  # (B, N, 1, W)
    d2 = torch.where(valid, dy * dy + dx * dx, 1e6)
    pos = torch.where(is_pos, d2, 1e6).amin(dim=1)
    neg = torch.where(is_pos, 1e6, d2).amin(dim=1)
    return torch.stack([pos, neg], dim=1)


def nearest_dist(points: torch.Tensor, h: int, w: int,
                 norm_radius: float = 260.0) -> torch.Tensor:
    """sqrt of `nearest_sq_dist`, correctly rounded to float32 as XLA's
    is: the root is taken in float64 and rounded once (torch's float32
    sqrt on the CPU is off by an ulp on ~0.7% of its inputs); float64
    clicks keep float64 (a float64 net's maps)."""
    return torch.sqrt(nearest_sq_dist(points, h, w, norm_radius).double()
                      ).to(torch.promote_types(points.dtype, torch.float32))


def dist_maps(points: torch.Tensor, h: int, w: int,
              norm_radius: float = 260.0) -> torch.Tensor:
    """(B, N, 3) clicks -> (B, 2, H, W): the positive and the negative
    map, each tanh(2 sqrt(d^2)) of `nearest_sq_dist`."""
    return torch.tanh(2.0 * nearest_dist(points, h, w, norm_radius))


class SepConvHead(nn.Module):
    """`num_layers` of (depthwise 3x3, pointwise 1x1 to `mid_channels`,
    BN, ReLU), then a 1x1 classifier with bias. flax names the convs
    Conv_0.. in that order (dw, pw, dw, pw, .., classifier) and the BNs
    BatchNorm_0.."""

    def __init__(self, cin: int, num_outputs: int, mid_channels: int,
                 num_layers: int = 1):
        super().__init__()
        convs, bns, ch = [], [], cin
        for _ in range(num_layers):
            convs.append(nn.Conv2d(ch, ch, 3, padding=1, groups=ch,
                                   bias=False))
            convs.append(nn.Conv2d(ch, mid_channels, 1, bias=False))
            bns.append(FlaxBatchNorm2d(mid_channels))
            ch = mid_channels
        convs.append(nn.Conv2d(ch, num_outputs, 1))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, bn in enumerate(self.bns):
            x = F.relu(bn(self.convs[2 * i + 1](self.convs[2 * i](x))))
        return self.convs[-1](x)


class BRSDeepLabV3Plus(nn.Module):
    """The DeepLab variant BRS runs on: ResNet-50 (no dilation), the
    stage-1 skip projected to 32 channels, ASPP (128 channels) at stage 4,
    and a separable head giving `ch` channels at 1/4."""

    def __init__(self, ch: int = 128, in_channels: int = 3):
        super().__init__()
        self.backbone = ResNet("bottleneck", (3, 4, 6, 3),
                               in_channels=in_channels)
        self.skip_conv = nn.Conv2d(256, 32, 3, padding=1, bias=False)
        self.skip_bn = FlaxBatchNorm2d(32)
        self.aspp = ASPP(2048, (12, 24, 36), ch)
        self.head_module = SepConvHead(ch + 32, ch, ch, num_layers=2)

    def backbone_feats(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(skip, c4): the `after_c4` insertion point and the unperturbed
        skip branch that finishes from it."""
        feats = self.backbone(x)
        skip = F.relu(self.skip_bn(self.skip_conv(feats["c1"])))
        return skip, feats["c4"]

    def aspp_concat(self, skip: torch.Tensor,
                    c4: torch.Tensor) -> torch.Tensor:
        """The `after_aspp` tensor: the ASPP at c4 upsampled onto the
        skip's grid, then the skip (ch + 32 channels)."""
        a = resize_nchw(self.aspp(c4), skip.shape[-2:])
        return torch.cat([a, skip], dim=1)

    def head(self, after_aspp: torch.Tensor) -> torch.Tensor:
        return self.head_module(after_aspp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.aspp_concat(*self.backbone_feats(x)))


class DistMapsModel(nn.Module):
    """The click-to-mask model: (B, 3, H, W) normalized RGB and (B, N, 3)
    clicks -> (B, 1, H, W) logits."""

    def __init__(self, ch: int = 128, norm_radius: float = 260.0):
        super().__init__()
        self.norm_radius = norm_radius
        self.rgb_conv1 = nn.Conv2d(5, 8, 1)
        self.rgb_bn = FlaxBatchNorm2d(8)
        self.rgb_conv2 = nn.Conv2d(8, 3, 1)
        self.feature_extractor = BRSDeepLabV3Plus(ch)
        self.inst_head = SepConvHead(ch, 1, ch // 2, num_layers=2)

    def _fuse(self, image: torch.Tensor, points: torch.Tensor
              ) -> torch.Tensor:
        h, w = image.shape[-2:]
        coord = dist_maps(points, h, w, self.norm_radius)
        x = self.rgb_conv1(torch.cat([image, coord], dim=1))
        x = self.rgb_bn(F.leaky_relu(x, 0.2))
        return self.rgb_conv2(x)

    def features(self, image: torch.Tensor, points: torch.Tensor,
                 insertion_mode: str = "after_aspp"
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(feats, aux): the tensor BRS perturbs at `insertion_mode`, and
        the unperturbed side branch that finishes from it (the skip for
        "after_c4", else None)."""
        if insertion_mode not in INSERTION_MODES:
            raise ValueError(f"unknown insertion_mode {insertion_mode!r}")
        fe = self.feature_extractor
        skip, c4 = fe.backbone_feats(self._fuse(image, points))
        if insertion_mode == "after_c4":
            return c4, skip
        after_aspp = fe.aspp_concat(skip, c4)
        if insertion_mode == "after_aspp":
            return after_aspp, None
        return fe.head(after_aspp), None

    def logits_from_features(self, feats: torch.Tensor,
                             out_hw: Tuple[int, int],
                             scale: Optional[torch.Tensor] = None,
                             bias: Optional[torch.Tensor] = None,
                             insertion_mode: str = "after_aspp",
                             aux: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """Finish the forward from the insertion point, with the
        per-channel perturbation feats * (1 + scale) + bias when `scale`
        is given; the logits resized to `out_hw`."""
        if insertion_mode not in INSERTION_MODES:
            raise ValueError(f"unknown insertion_mode {insertion_mode!r}")
        if scale is not None:
            feats = (feats * (1.0 + scale)[None, :, None, None]
                     + bias[None, :, None, None])
        fe = self.feature_extractor
        if insertion_mode == "after_c4":
            feats = fe.aspp_concat(aux, feats)
        if insertion_mode != "after_deeplab":
            feats = fe.head(feats)
        return resize_nchw(self.inst_head(feats), out_hw)

    def forward(self, image: torch.Tensor,
                points: torch.Tensor) -> torch.Tensor:
        after_aspp, _ = self.features(image, points)
        return self.logits_from_features(after_aspp, image.shape[-2:])
