"""Hand-written CUDA kernels (`csrc/`): wrappers, launch counts and plain
versions.

K1 `morph.trimap`, K2 `morph.morph` (replacing `ops/pallas/morph.py`),
K3 `connected.connected_components_compact` (replacing
`ops/pallas/flood.py`), K4 `attention.masked_memory_attention`, K5
`attention.attention_bwd_dq` and K6 `attention.attention_bwd_dkv`
(replacing `ops/pallas/attention.py`'s forward and backward). A wrapper
runs its plain version for a CPU tensor and launches its kernel for a CUDA
tensor; nothing builds at import.
"""

from .attention import ATTENTION, ATTENTION_BWD_DKV, ATTENTION_BWD_DQ
from .connected import FLOOD
from .morph import MORPH, TRIMAP

COUNTERS = (TRIMAP, MORPH, FLOOD, ATTENTION, ATTENTION_BWD_DQ,
            ATTENTION_BWD_DKV)


def reset_counts() -> None:
    for c in COUNTERS:
        c.calls = c.launches = 0


def counts() -> dict:
    """{kernel: (calls, device launches)} since the last reset."""
    return {c.name: (c.calls, c.launches) for c in COUNTERS}
