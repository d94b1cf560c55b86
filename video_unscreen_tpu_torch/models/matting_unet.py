"""MattingUNet: the temporal alpha-matte refiner, as a torch module.

Port of `video_unscreen_tpu/models/matting_unet.py` (inference form): a
ResShortCut encoder/decoder with resnet18-shaped stages [2, 2, 2, 2],
input RGB (normalized) + previous alpha + one-hot trimap (7 channels),
five shortcut stacks, 4x4 stride-2 transposed-conv upsampling and a
`(tanh + 1) / 2` output. NCHW layout. The net runs in its convolutions'
dtype (`models/precision.py:convs_to`, float32 or bfloat16); the output
head takes the last convolution's result in float32, so the alpha is
float32 either way. flax's bfloat16 net takes the tanh in bfloat16 too,
in alpha steps of 2^-9 to 2^-8 around 0.5, the alpha >= 128 threshold;
the float32 head keeps the masks closer to the float32 net's (PERF.md).

Submodules carry the flax module names (`enc_conv1`, `BasicBlockEnc_3`,
`Conv_0`, `BatchNorm_1`, ...) so a checkpoint maps one to one
(`utils/checkpoint.py:load_matting_unet`). The JAX package's
`SubpixelConvTranspose` (four 2x2 phase convs, a rewrite for XLA) is a
plain `nn.ConvTranspose2d(k=4, s=2, p=1)` here.

`spectral_normalize_tree` folds the reference's SpectralNorm wrappers into
a state dict's conv weights, as the JAX package folds its params tree.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import FlaxBatchNorm2d

_BN_EPS = 1e-5  # flax BatchNorm's default epsilon
# |x| from which the float32 tanh of XLA (Eigen's rational approximation)
# returns exactly +-1; a correctly rounded tanh gets there only at ~9.01
_TANH_SATURATION = 7.99881172180175781


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=False)


def _bn(c: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(c, eps=_BN_EPS)


def _up(c: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(c, c, 4, stride=2, padding=1, bias=False)


class BasicBlockEnc(nn.Module):
    """Encoder residual block; the projection is AvgPool(2) + 1x1 conv +
    BN."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.stride = stride
        self.use_projection = use_projection
        self.Conv_0 = _conv3x3(inplanes, planes, stride)
        self.BatchNorm_0 = _bn(planes)
        self.Conv_1 = _conv3x3(planes, planes)
        self.BatchNorm_1 = _bn(planes)
        if use_projection:
            self.Conv_2 = _conv1x1(inplanes, planes)
            self.BatchNorm_2 = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        identity = x
        if self.use_projection:
            if self.stride != 1:
                identity = F.avg_pool2d(identity, 2, self.stride)
            identity = self.BatchNorm_2(self.Conv_2(identity))
        return F.relu(out + identity)


class BasicBlockDec(nn.Module):
    """Decoder residual block; a stride-2 block upsamples with a transposed
    conv, its projection is nearest x2 + 1x1 conv + BN."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.stride = stride
        self.use_projection = use_projection
        # flax numbers the plain convs in creation order: the upsampling
        # ConvTranspose_0 takes no Conv_ number, a stride-1 first conv does
        if stride > 1:
            self.ConvTranspose_0 = _up(inplanes)
            names = ("ConvTranspose_0", "Conv_0", "Conv_1")
        else:
            self.Conv_0 = _conv3x3(inplanes, inplanes)
            names = ("Conv_0", "Conv_1", "Conv_2")
        self._first, self._second, self._proj = names
        setattr(self, self._second, _conv3x3(inplanes, planes))
        self.BatchNorm_0 = _bn(inplanes)
        self.BatchNorm_1 = _bn(planes)
        if use_projection:
            setattr(self, self._proj, _conv1x1(inplanes, planes))
            self.BatchNorm_2 = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self, self._first)(x)
        out = F.leaky_relu(self.BatchNorm_0(out), 0.2)
        out = self.BatchNorm_1(getattr(self, self._second)(out))
        identity = x
        if self.use_projection:
            if self.stride != 1:
                identity = F.interpolate(identity, scale_factor=2,
                                         mode="nearest")
            identity = self.BatchNorm_2(getattr(self, self._proj)(identity))
        return F.leaky_relu(out + identity, 0.2)


class ShortcutStack(nn.Module):
    """conv3x3 - ReLU - BN, twice."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.Conv_0 = _conv3x3(inplanes, planes)
        self.BatchNorm_0 = _bn(planes)
        self.Conv_1 = _conv3x3(planes, planes)
        self.BatchNorm_1 = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(F.relu(self.Conv_0(x)))
        return self.BatchNorm_1(F.relu(self.Conv_1(x)))


class MattingUNet(nn.Module):
    """(N, 3, H, W) normalized RGB + (N, 1, H, W) previous alpha + (N, 3,
    H, W) one-hot trimap -> (N, 1, H, W) alpha in [0, 1]; H, W divisible
    by 32."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 midplanes: int = 32):
        super().__init__()
        self.enc_conv1 = _conv3x3(7, 32, 2)
        self.enc_bn1 = _bn(32)
        self.enc_conv2 = _conv3x3(32, midplanes)
        self.enc_bn2 = _bn(midplanes)
        self.enc_conv3 = _conv3x3(midplanes, 64, 2)
        self.enc_bn3 = _bn(64)

        def stages(block, prefix, plan, inplanes):
            names, i = [], 0
            for planes, blocks, stride in plan:
                for j in range(blocks):
                    s = stride if j == 0 else 1
                    proj = j == 0 and (s != 1 or inplanes != planes)
                    name = f"{prefix}_{i}"
                    setattr(self, name, block(inplanes, planes, s, proj))
                    names.append(name)
                    inplanes, i = planes, i + 1
            return names

        self._enc = stages(BasicBlockEnc, "BasicBlockEnc",
                           [(64, layers[0], 1), (128, layers[1], 2),
                            (256, layers[2], 2), (512, layers[3], 2)], 64)
        self._dec = stages(BasicBlockDec, "BasicBlockDec",
                           [(256, layers[0], 2), (128, layers[1], 2),
                            (64, layers[2], 2), (midplanes, layers[3], 2)],
                           512)
        self._layers = tuple(layers)
        for i, (cin, cout) in enumerate([(7, 32), (midplanes, midplanes),
                                         (64, 64), (128, 128), (256, 256)]):
            setattr(self, f"ShortcutStack_{i}", ShortcutStack(cin, cout))
        self.dec_conv1 = _up(midplanes)
        self.dec_bn1 = _bn(32)
        self.dec_conv2 = nn.Conv2d(32, 1, 3, padding=1, bias=True)

    def _run(self, names, x):
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, img: torch.Tensor, alpha_pre: torch.Tensor,
                trimap: torch.Tensor) -> torch.Tensor:
        # in the convolutions' dtype (`models/precision.py`); the head
        # below is float32 either way
        x = torch.cat([img, alpha_pre, trimap], dim=1).to(
            self.enc_conv1.weight.dtype)
        out = F.relu(self.enc_bn1(self.enc_conv1(x)))
        x1 = F.relu(self.enc_bn2(self.enc_conv2(out)))          # H/2
        out = F.relu(self.enc_bn3(self.enc_conv3(x1)))          # H/4
        splits, enc, feats, k = [], self._enc, [], 0
        for n in self._layers:
            splits.append(enc[k:k + n])
            k += n
        x2 = self._run(splits[0], out)                           # H/4
        x3 = self._run(splits[1], x2)                            # H/8
        x4 = self._run(splits[2], x3)                            # H/16
        out = self._run(splits[3], x4)                           # H/32
        for i, f in enumerate((x, x1, x2, x3, x4)):
            feats.append(getattr(self, f"ShortcutStack_{i}")(f))
        k = 0
        for n, skip in zip(self._layers, feats[:0:-1]):
            out = self._run(self._dec[k:k + n], out) + skip
            k += n
        out = F.leaky_relu(self.dec_bn1(self.dec_conv1(out)), 0.2) + feats[0]
        raw = self.dec_conv2(out).float()
        # exact 0/1 beyond the reference's saturation point: downstream
        # tests `alpha > 0` (color_correct), which must not hinge on which
        # device's tanh rounds a deep-background pixel to 0
        alpha = (torch.tanh(raw) + 1.0) / 2.0
        alpha = torch.where(raw <= -_TANH_SATURATION, 0.0, alpha)
        return torch.where(raw >= _TANH_SATURATION, 1.0, alpha)


def spectral_normalize_tree(state_dict: Dict[str, torch.Tensor],
                            n_power_iterations: int = 20,
                            seed: int = 0) -> Dict[str, torch.Tensor]:
    """Every conv weight of a MattingUNet state dict divided by its leading
    singular value: the constant-at-inference form of the reference's
    SpectralNorm (`vmatting/model.py:45-113`), as the JAX package's
    `spectral_normalize_tree` computes it. sigma comes from a float64
    power iteration on the (out, in * kh * kw) matricization of the flax
    kernel, from `RandomState(seed)` draws taken over the kernels in flax's
    order (its params tree flattened, keys sorted at every level). A 4x4
    weight is a transposed conv's, whose flax kernel is the (kh, kw, in,
    out) one flipped in both spatial axes (`utils/checkpoint.py`). Returns
    a new state dict; the other entries are the given tensors."""
    rng = np.random.RandomState(seed)
    kernels = sorted(
        (tuple(k[:-len(".weight")].split(".")) + ("kernel",), k)
        for k, w in state_dict.items()
        if k.endswith(".weight") and w.dim() == 4)
    out = dict(state_dict)
    for _, key in kernels:
        w = state_dict[key]
        arr = w.detach().to("cpu", torch.float32).numpy()
        transposed = tuple(arr.shape[2:]) == (4, 4)
        kern = (arr.transpose(2, 3, 0, 1)[::-1, ::-1] if transposed
                else arr.transpose(2, 3, 1, 0))
        # (out, rest) in float64 once: a float32 matrix is cast anew at
        # every product, to the same values and the same products
        mat = kern.reshape(-1, kern.shape[-1]).T.astype(np.float64)
        u = rng.randn(mat.shape[0]).astype(np.float64)
        for _ in range(n_power_iterations):
            v = mat.T @ u
            v /= np.linalg.norm(v) + 1e-12
            u = mat @ v
            u /= np.linalg.norm(u) + 1e-12
        sigma = float(u @ mat @ v)
        kern = kern / np.float32(max(sigma, 1e-12))
        arr = (kern[::-1, ::-1].transpose(2, 3, 0, 1) if transposed
               else kern.transpose(3, 2, 0, 1))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=w.dtype, device=w.device)
    return out
