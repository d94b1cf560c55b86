"""The port's parallel layer: the mesh over ranks, its shardings and the
ranks' launcher (`mesh.py`, `launch.py`), tensor parallelism over the
model axis (`tensor_parallel.py`), the chunk upload and `FrameStreamer`
(`streaming.py`), the JAX multi-chip dry run (`dryrun.py`), and the
trainers, on one device or over a mesh (`train*.py`, `families.py`)."""

from .mesh import (batch_sharding, make_mesh, param_shardings,  # noqa: F401
                   replicate, spatial_sharding)
from .streaming import FrameStreamer  # noqa: F401
