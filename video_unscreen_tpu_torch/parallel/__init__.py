"""The port's parallel layer: the mesh over ranks and the ranks' launcher
(`mesh.py`, `launch.py`), the chunk upload and `FrameStreamer`
(`streaming.py`), the inference half of the JAX multi-chip dry run
(`dryrun.py`), and training on one device (`train*.py`; over ranks:
ROADMAP.md, Queue 1, item 21c)."""

from .mesh import batch_sharding, make_mesh, replicate  # noqa: F401
from .streaming import FrameStreamer  # noqa: F401
