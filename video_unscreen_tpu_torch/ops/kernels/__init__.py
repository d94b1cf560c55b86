"""Hand-written CUDA kernels (`csrc/`): wrappers, launch counts and plain
versions.

K1 `morph.trimap`, K2 `morph.morph` (replacing `ops/pallas/morph.py`) and
K3 `connected.connected_components_compact` (replacing
`ops/pallas/flood.py`). A wrapper runs its plain version for a CPU tensor
and launches its kernel for a CUDA tensor; nothing builds at import.
"""

from .connected import FLOOD
from .morph import MORPH, TRIMAP

COUNTERS = (TRIMAP, MORPH, FLOOD)


def reset_counts() -> None:
    for c in COUNTERS:
        c.calls = c.launches = 0


def counts() -> dict:
    """{kernel: (calls, device launches)} since the last reset."""
    return {c.name: (c.calls, c.launches) for c in COUNTERS}
