"""Device-to-host wire packing of alpha-like planes (port of
`video_unscreen_tpu/ops/wirepack.py`).

The host-fetch pipelines' download is mostly full-resolution uint8 alpha
planes whose pixels are nearly all exactly 0 or 255 (the trimap's hard
reset forces everything outside the unknown band to 0/255). Packed, a
plane crosses the link as

    [hi bits n/8] [band bits n/8] [band values K] [count 4 B LE]

- `hi` bit j of byte i: pixel 8i+j == 255 (row-major flat order).
- `band` bit: 0 < pixel < 255 (the unknown band).
- `band values`: the band pixels' uint8 values in row-major order,
  capacity K; `count` is the TRUE number of band pixels. count > K means
  the budget overflowed: the values beyond K are dropped, the buffer does
  not reconstruct, and the caller fetches the full plane instead (the
  fused pipelines keep it on the device for that).

0.25 B/px + K against 1 B/px raw: about 3.3x fewer bytes at the default
K = n/16. Reconstruction is bit-exact. The layout is byte for byte the JAX
package's; `pack_plane` runs on any device and takes a batch, the unpack
functions are numpy on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_BIT_WEIGHTS = tuple(1 << j for j in range(8))


def packed_size(h: int, w: int, capacity: Optional[int] = None) -> int:
    n = h * w
    assert n % 8 == 0, "plane size must be a multiple of 8"
    if capacity is None:
        capacity = default_capacity(h, w)
    return n // 4 + capacity + 4


def default_capacity(h: int, w: int) -> int:
    return (h * w) // 16


def _bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., n / 8) uint8, bit j of byte i = element 8i+j
    (numpy's `bitorder='little'`)."""
    bb = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                           device=bits.device)
    return (bb * weights).sum(dim=-1).to(torch.uint8)


def pack_plane(plane: torch.Tensor,
               capacity: Optional[int] = None) -> torch.Tensor:
    """(..., h, w) float or uint8 planes of 0..255 -> (..., packed_size)
    uint8 on the planes' device: each plane clipped to 0..255, truncated to
    uint8 and packed on its own."""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    if capacity is None:
        capacity = default_capacity(h, w)
    a = plane.clamp(0, 255).to(torch.uint8).reshape(-1, h * w)
    hi = a == 255
    band = (a > 0) & (a < 255)
    count = band.sum(dim=-1, dtype=torch.int32)
    pos = torch.cumsum(band, dim=-1, dtype=torch.int32) - 1
    # band pixels past the capacity, and every other pixel, land in the
    # extra slot K, which is cut off (JAX's scatter with mode="drop")
    idx = torch.where(band, pos.clamp_max(capacity), capacity)
    vals = torch.zeros((a.shape[0], capacity + 1), dtype=torch.uint8,
                       device=a.device)
    vals.scatter_(1, idx.to(torch.int64), torch.where(band, a, 0))
    count_le = torch.stack([(count >> s) & 0xFF for s in (0, 8, 16, 24)],
                           dim=-1).to(torch.uint8)
    out = torch.cat([_bits_to_bytes(hi), _bits_to_bytes(band),
                     vals[:, :capacity], count_le], dim=-1)
    return out.reshape(lead + (out.shape[-1],))


def unpack_plane(buf: np.ndarray, h: int, w: int,
                 capacity: Optional[int] = None) -> Optional[np.ndarray]:
    """Host-side inverse of `pack_plane`: the (h, w) uint8 plane, or None
    when the band budget overflowed (count > capacity); the caller then
    fetches the full plane from the device."""
    n = h * w
    if capacity is None:
        capacity = default_capacity(h, w)
    buf = np.asarray(buf, np.uint8)
    assert buf.size == packed_size(h, w, capacity), (
        f"packed buffer size {buf.size} != {packed_size(h, w, capacity)}")
    count = int(buf[-4:].view("<u4")[0])
    if count > capacity:
        return None
    hi = np.unpackbits(buf[:n // 8], bitorder="little")
    out = np.where(hi.astype(bool), 255, 0).astype(np.uint8)
    band_idx = np.flatnonzero(
        np.unpackbits(buf[n // 8:n // 4], bitorder="little"))
    out[band_idx] = buf[n // 4:n // 4 + capacity][:band_idx.size]
    return out.reshape(h, w)


def unpack_planes(bufs: np.ndarray, h: int, w: int,
                  capacity: Optional[int] = None,
                  fallback: Optional[Callable[[int], np.ndarray]] = None
                  ) -> np.ndarray:
    """Unpack an (N, packed_size) batch to (N, h, w) uint8. `fallback(i)`
    supplies plane i whole where its band budget overflowed; without one
    an overflow raises ValueError."""
    out = np.empty((bufs.shape[0], h, w), np.uint8)
    for i in range(bufs.shape[0]):
        plane = unpack_plane(bufs[i], h, w, capacity)
        if plane is None:
            if fallback is None:
                raise ValueError(
                    f"packed plane {i} overflowed its band budget and no "
                    f"fallback was provided")
            plane = np.asarray(fallback(i), np.uint8)
        out[i] = plane
    return out
