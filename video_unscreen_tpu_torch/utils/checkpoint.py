"""Read flax msgpack checkpoints and map them onto torch modules.

`read_msgpack` is a minimal reader for the layout `flax.serialization`
writes: maps, strings, binaries, ints, floats, nil/bools, arrays, and ext
type 1 (an ndarray: a msgpack `(shape, dtype_name, raw_bytes)` triple,
flax `_ndarray_to_bytes`) or 3 (a numpy scalar, the same triple). It needs
no `msgpack` package and slices a `memoryview` of the file, so the arrays
are views of one buffer and an 87 MB checkpoint reads in well under a
second.

`load_matting_unet` maps the MattingUNet's flax variables to a torch
`state_dict` for `models/matting_unet.py:MattingUNet`:
- conv kernels HWIO -> OIHW;
- 4x4 transposed-conv kernels (flax: a conv over the stride-dilated input
  padded by 2, kernel unflipped) -> `nn.ConvTranspose2d(k=4, s=2, p=1)`
  weights (in, out, kh, kw) with both spatial axes flipped;
- BatchNorm `scale`/`bias` and `batch_stats` `mean`/`var` ->
  `weight`/`bias`/`running_mean`/`running_var`.

`state_dict_from_variables` maps a flax variables tree (nested dicts of
arrays: numpy, or JAX arrays, which it reads as numpy) to a `state_dict`
by name: conv kernels HWIO -> OIHW, BatchNorm as above (flax's eps 1e-5
kept by the modules), flax's auto-names taken by order: `Bottleneck_3` ->
`blocks.3`, `Conv_2` -> `convs.2`, `BatchNorm_1` -> `bns.1`, `ResBlock_0`
-> `resblocks.0`, `Refine_1` -> `refines.1`, `ASPPConv_2` -> `branches.2`,
`_ABN_1` -> `abns.1`, `InvertedResidual_4` -> `irs.4`; explicit names
(`encoder_q`, `stem_conv1`, `kv_m`, `cls_out`, `layer3_17`, ...) stay.
`load_stm`, `load_deeplab`, `load_schp` and `load_iseg` read a msgpack
file (or take a tree) and map it so, for `models/stm.py:STM`,
`models/deeplab.py` (MobileNetV2 variant included),
`models/human_parse.py:SCHPHumanParser` and `models/iseg.py:DistMapsModel`.

`save_stm` is its inverse: it writes an STM's `params` and `batch_stats`
in the layout flax's `to_bytes` writes (maps of strings, each array an
ext type 1 `(shape, dtype_name, raw_bytes)`), which `read_msgpack` and the
JAX package's `utils/checkpoint.py:load_variables` read. Torch's
`num_batches_tracked` is not written.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self) -> Any:
        tag = self.uint(1)
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if tag <= 0x8F:
            return self.map(tag & 0x0F)
        if tag <= 0x9F:
            return self.array(tag & 0x0F)
        if tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.uint(1 << (tag - 0xC4)))
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (tag - 0xC7))
            return self.ext(self.sint(1), self.take(n))
        if tag == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if tag == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= tag <= 0xCF:  # uint 8/16/32/64
            return self.uint(1 << (tag - 0xCC))
        if 0xD0 <= tag <= 0xD3:  # int 8/16/32/64
            return self.sint(1 << (tag - 0xD0))
        if 0xD4 <= tag <= 0xD8:  # fixext 1/2/4/8/16
            code = self.sint(1)
            return self.ext(code, self.take(1 << (tag - 0xD4)))
        if tag in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.uint(1 << (tag - 0xD9))), "utf-8")
        if tag in (0xDC, 0xDD):  # array 16/32
            return self.array(self.uint(2 if tag == 0xDC else 4))
        if tag in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if tag == 0xDE else 4))
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, code: int, data: memoryview) -> Any:
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(data).value()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def read_msgpack(path: Union[str, os.PathLike]) -> Any:
    """The tree stored in a flax msgpack file, arrays as numpy views."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"short read of {path}")
    reader = _Reader(memoryview(buf))
    tree = reader.value()
    if reader.pos != len(buf):
        raise ValueError(f"trailing bytes in {path}")
    return tree


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def load_matting_unet(source) -> Dict[str, torch.Tensor]:
    """state_dict for `MattingUNet` from a flax msgpack path or from the
    flax variables as a nested dict of numpy arrays."""
    tree = source if isinstance(source, dict) else read_msgpack(source)
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree["params"]):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and arr.shape[:2] == (4, 4):
            state[f"{mod}.weight"] = _tensor(
                arr[::-1, ::-1].transpose(2, 3, 0, 1))
        elif leaf == "kernel":
            state[f"{mod}.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
        elif leaf in ("scale", "bias"):
            state[f"{mod}.{'weight' if leaf == 'scale' else 'bias'}"] = \
                _tensor(arr)
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(tree.get("batch_stats", {})):
        mod = ".".join(path[:-1])
        state[f"{mod}.{stats[path[-1]]}"] = _tensor(arr)
        state[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return state


# flax auto-name prefix -> the port's ModuleList attribute
_AUTO_NAMES = {"Conv": "convs", "BatchNorm": "bns", "Bottleneck": "blocks",
               "BasicBlock": "blocks", "ResBlock": "resblocks",
               "Refine": "refines", "ASPPConv": "branches", "_ABN": "abns",
               "InvertedResidual": "irs"}
_AUTO_RE = re.compile(r"^(_?[A-Za-z]+)_(\d+)$")


def _module_path(path: Tuple[str, ...]) -> str:
    parts = []
    for name in path:
        m = _AUTO_RE.match(name)
        if m and m.group(1) in _AUTO_NAMES:
            parts.append(f"{_AUTO_NAMES[m.group(1)]}.{m.group(2)}")
        else:
            parts.append(name)
    return ".".join(parts)


def state_dict_from_variables(tree: dict) -> Dict[str, torch.Tensor]:
    """state_dict from a flax variables tree ({"params": ...,
    "batch_stats": ...}, leaves numpy or JAX arrays), mapped by name.
    Every leaf maps to one entry; a leaf of an unknown kind raises here,
    and one the model does not have raises in `load_state_dict`
    (strict)."""
    unknown = set(tree) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected collections {sorted(unknown)}")
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree["params"]):
        mod, leaf = _module_path(path[:-1]), path[-1]
        if leaf == "kernel" and arr.ndim == 4:
            state[f"{mod}.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
        elif leaf == "bias":
            state[f"{mod}.bias"] = _tensor(arr)
        elif leaf == "scale":
            state[f"{mod}.weight"] = _tensor(arr)
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(tree.get("batch_stats", {})):
        if path[-1] not in stats:
            raise ValueError(f"unexpected batch stat {'/'.join(path)}")
        mod = _module_path(path[:-1])
        state[f"{mod}.{stats[path[-1]]}"] = _tensor(arr)
        state[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return state


def load_stm(source) -> Dict[str, torch.Tensor]:
    """state_dict for `models/stm.py:STM` from a flax msgpack path or from
    the flax variables tree (`state_dict_from_variables`)."""
    tree = source if isinstance(source, dict) else read_msgpack(source)
    return state_dict_from_variables(tree)


# DeepLab's and SCHP's trees map by the same names (`ASPPConv_1` ->
# `branches.1`, `_ABN_0` -> `abns.0`, the MobileNetV2 variant's
# `InvertedResidual_3` -> `irs.3`; `cls_out` keeps its bias)
load_deeplab = load_schp = load_stm


def load_iseg(source) -> Dict[str, torch.Tensor]:
    """state_dict for `models/iseg.py:DistMapsModel` from a flax msgpack
    path (weights/iseg.msgpack) or a variables tree (a seeded
    `DistMapsModel.init`). The compact `SepConvHead`'s auto-names map by
    order (`Conv_3` -> `convs.3`, `BatchNorm_1` -> `bns.1`), and a
    depthwise kernel (kh, kw, 1, C) becomes the (C, 1, kh, kw) weight of a
    `groups=C` conv by the same HWIO -> OIHW transpose as any other."""
    tree = source if isinstance(source, dict) else read_msgpack(source)
    return state_dict_from_variables(tree)


_FLAX_AUTO = {v: k for k, v in _AUTO_NAMES.items() if k != "BasicBlock"}


def _flax_path(module: str) -> Tuple[str, ...]:
    """`encoder_q.blocks.3.convs.1` -> (encoder_q, Bottleneck_3, Conv_1):
    `_module_path` backwards (the STM's blocks are bottlenecks)."""
    parts, out = module.split("."), []
    while parts:
        name = parts.pop(0)
        if name in _FLAX_AUTO and parts and parts[0].isdigit():
            out.append(f"{_FLAX_AUTO[name]}_{parts.pop(0)}")
        else:
            out.append(name)
    return tuple(out)


def _pack(obj: Any, out: bytearray) -> None:
    """msgpack-encode `obj` (dict, str, bytes, int, tuple, ndarray) into
    `out`, each with the smallest header, as msgpack's packer does."""
    def header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
               widths: Tuple[int, ...]) -> None:
        if fix is not None and n <= fix_max:
            out.append(fix | n)
            return
        for code, width in zip(codes, widths):
            if n < 1 << (8 * width):
                out.append(code)
                out.extend(n.to_bytes(width, "big"))
                return
        raise ValueError(f"msgpack: length {n} too large")

    if isinstance(obj, dict):
        header(len(obj), 0x80, 15, (0xDE, 0xDF), (2, 4))
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), (1, 2, 4))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        header(len(obj), None, -1, (0xC4, 0xC5, 0xC6), (1, 2, 4))
        out += obj
    elif isinstance(obj, (tuple, list)):
        header(len(obj), 0x90, 15, (0xDC, 0xDD), (2, 4))
        for val in obj:
            _pack(val, out)
    elif isinstance(obj, int) and 0 <= obj < 1 << 64:
        header(obj, 0x00, 0x7F, (0xCC, 0xCD, 0xCE, 0xCF), (1, 2, 4, 8))
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack((tuple(int(n) for n in obj.shape), obj.dtype.name,
               obj.tobytes("C")), payload)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            header(n, None, -1, (0xC7, 0xC8, 0xC9), (1, 2, 4))
        out.append(_EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def save_stm(path: Union[str, os.PathLike], model: torch.nn.Module) -> None:
    """Write `models/stm.py:STM`'s variables as a flax msgpack file (the
    inverse of `load_stm`): conv weights OIHW -> HWIO kernels, BatchNorm
    `weight`/`bias` -> `scale`/`bias`, `running_mean`/`running_var` ->
    `batch_stats` `mean`/`var`, all float32; `num_batches_tracked` is
    dropped. The file is written whole under a temporary name, then
    renamed."""
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    leaf_names = {"running_mean": ("batch_stats", "mean"),
                  "running_var": ("batch_stats", "var")}
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "num_batches_tracked":
            continue
        if leaf in leaf_names:
            coll, name = leaf_names[leaf]
        elif leaf == "weight":
            coll, name = "params", "kernel" if arr.ndim == 4 else "scale"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            raise ValueError(f"unexpected state entry {key}")
        node = tree[coll]
        for part in _flax_path(mod):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    buf = bytearray()
    _pack(tree, buf)
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)
