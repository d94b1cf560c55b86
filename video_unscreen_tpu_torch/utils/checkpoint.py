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
"""

from __future__ import annotations

import os
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
