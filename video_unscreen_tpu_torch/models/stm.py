"""STM: the Space-Time Memory network of bg mode's tracker.

Port of `video_unscreen_tpu/models/stm.py`: memory and query encoders on a
resnet50 trunk through layer 3 (1024 channels at 1/16), KeyValue heads
1024 -> (128, 512), the masked memory read over the bank, the refinement
decoder to 2-class logits upsampled x4, and the soft aggregation.

Convolutions are NCHW. The memory keys and values keep the JAX package's
(B, T, Hm, Wm, C) layout: row-major, that is the (Lk, C) matrix the
attention kernel reads, so `memorize` returns NHWC and the bank needs no
transpose. `memory_read` goes through `MaskedMemoryAttention`
(`ops/kernels/attention.py`), one call for the whole batch as the JAX
package vmaps the read: on a CUDA tensor its forward is kernel K4 and its
backward kernels K5 and K6, on a CPU tensor their plain versions; there is
no other branch; under `torch.no_grad` only K4 runs. In train
mode (`nn.Module.train()`, the JAX package's `train=True`) the BatchNorms
update their statistics as flax's do (`batchnorm.FlaxBatchNorm2d`).

The net runs in its convolutions' dtype (`models/precision.py:convs_to`;
the fused bg pipeline's default is bfloat16): the inputs are cast to it,
the memory keys and values come out in it, and the read takes q, k and v
upcast to float32 (K4; float64 stays), as the JAX package's einsum read with
`preferred_element_type=float32` multiplies bfloat16-stored values
exactly and sums in float32; the decoder casts the read back.

Submodule names follow flax's creation order (`convs.N` for `Conv_N`,
`resblocks.N` for `ResBlock_N`, `refines.N` for `Refine_N`) so
`utils/checkpoint.py:load_stm` maps a flax tree by order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import resize_nchw
from ..ops.kernels.attention import MaskedMemoryAttention
from .resnet import ResNet


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResBlock(nn.Module):
    """Pre-activation residual block."""

    def __init__(self, cin: int, outdim: int):
        super().__init__()
        convs = [_conv3(cin, outdim), _conv3(outdim, outdim)]
        if cin != outdim:
            convs.append(_conv3(cin, outdim))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.convs[0](F.relu(x))
        r = self.convs[1](F.relu(r))
        if len(self.convs) > 2:
            x = self.convs[2](x)
        return x + r


class Refine(nn.Module):
    """Skip refinement: conv + ResBlock on the skip, plus the x2 upsampled
    coarser map, then a ResBlock."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.convs = nn.ModuleList([_conv3(cin, planes)])
        self.resblocks = nn.ModuleList([ResBlock(planes, planes),
                                        ResBlock(planes, planes)])

    def forward(self, f: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
        s = self.resblocks[0](self.convs[0](f))
        h, w = pm.shape[-2:]
        return self.resblocks[1](s + resize_nchw(pm, (2 * h, 2 * w)))


class Decoder(nn.Module):
    """Refinement decoder to 2-channel logits at the input resolution."""

    def __init__(self, mdim: int = 256, in4: int = 1024, in3: int = 512,
                 in2: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([_conv3(in4, mdim), _conv3(mdim, 2)])
        self.resblocks = nn.ModuleList([ResBlock(mdim, mdim)])
        self.refines = nn.ModuleList([Refine(in3, mdim), Refine(in2, mdim)])

    def forward(self, r4, r3, r2) -> torch.Tensor:
        m4 = self.resblocks[0](self.convs[0](r4.to(
            self.convs[0].weight.dtype)))
        m3 = self.refines[0](r3, m4)   # 1/8
        m2 = self.refines[1](r2, m3)   # 1/4
        p2 = self.convs[1](F.relu(m2))
        h, w = p2.shape[-2:]
        return resize_nchw(p2, (4 * h, 4 * w))


class KeyValue(nn.Module):
    """1024 -> (keydim, valdim) heads."""

    def __init__(self, cin: int = 1024, keydim: int = 128,
                 valdim: int = 512):
        super().__init__()
        self.convs = nn.ModuleList([_conv3(cin, keydim),
                                    _conv3(cin, valdim)])

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.convs[0](x), self.convs[1](x)


def memory_read(mem_k: torch.Tensor, mem_v: torch.Tensor,
                valid: torch.Tensor, q_k: torch.Tensor,
                q_v: torch.Tensor) -> torch.Tensor:
    """Masked scaled-dot-product read over the memory bank.

      mem_k: (B, T, Hm, Wm, Ck), mem_v: (B, T, Hm, Wm, Cv),
      valid: (B, T) slot validity, q_k: (B, Hm, Wm, Ck),
      q_v: (B, Hm, Wm, Cv).
    Returns (B, Hm, Wm, 2 * Cv): the read result, then the query value.
    """
    b, t, hm, wm, ck = mem_k.shape
    cv = mem_v.shape[-1]
    dt = torch.promote_types(mem_k.dtype, torch.float32)
    mk = mem_k.reshape(b, t * hm * wm, ck).to(dt)
    mv = mem_v.reshape(b, t * hm * wm, cv).to(dt)
    qk = q_k.reshape(b, hm * wm, ck).to(dt)
    mask = valid.to(torch.float32).repeat_interleave(hm * wm, dim=1)
    mem = MaskedMemoryAttention.apply(qk.contiguous(), mk.contiguous(),
                                      mv.contiguous(), mask.contiguous())
    return torch.cat([mem.reshape(b, hm, wm, cv), q_v.to(dt)], dim=-1)


class STM(nn.Module):
    """The full net: `memorize(frame, mask_fg, mask_bg) -> (k, v)` at 1/16
    (NHWC) and `segment(frame, mem_k, mem_v, valid) -> logits` (NCHW,
    2 channels, soft-aggregated). Frames are (B, 3, H, W) normalized."""

    def __init__(self):
        super().__init__()
        trunk = dict(block="bottleneck", layers=(3, 4, 6), num_stages=3)
        self.encoder_q = ResNet(**trunk)
        self.encoder_m = ResNet(**trunk)
        # 1-channel mask / other-mask convs summed into the memory stem
        self.conv1_m = nn.Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.conv1_o = nn.Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.kv_m = KeyValue()
        self.kv_q = KeyValue()
        self.decoder = Decoder()

    def memorize(self, frame: torch.Tensor, mask_fg: torch.Tensor,
                 mask_bg: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frame (B, 3, H, W); masks (B, H, W) in [0, 1]. Returns the
        memory key (B, Hm, Wm, 128) and value (B, Hm, Wm, 512)."""
        dt = self.conv1_m.weight.dtype
        extra = (self.conv1_m(mask_fg[:, None].to(dt))
                 + self.conv1_o(mask_bg[:, None].to(dt)))
        feats = self.encoder_m(frame.to(dt), stem_extra=extra)
        k, v = self.kv_m(feats["c3"])
        return (k.permute(0, 2, 3, 1).contiguous(),
                v.permute(0, 2, 3, 1).contiguous())

    def segment_raw(self, frame: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
        """Decoder logits (B, 2, H, W) before the soft aggregation."""
        feats = self.encoder_q(frame.to(self.conv1_m.weight.dtype))
        q_k, q_v = self.kv_q(feats["c3"])
        m4 = memory_read(mem_k, mem_v, valid, q_k.permute(0, 2, 3, 1),
                         q_v.permute(0, 2, 3, 1))
        return self.decoder(m4.permute(0, 3, 1, 2), feats["c2"],
                            feats["c1"])

    def segment(self, frame: torch.Tensor, mem_k: torch.Tensor,
                mem_v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        logits = self.segment_raw(frame, mem_k, mem_v, valid)
        ps = torch.softmax(logits, dim=1)[:, 1]
        em_bg = torch.clamp(1.0 - ps, 1e-7, 1 - 1e-7)
        em_fg = torch.clamp(ps, 1e-7, 1 - 1e-7)
        return torch.stack([torch.log(em_bg / (1.0 - em_bg)),
                            torch.log(em_fg / (1.0 - em_fg))], dim=1)
