"""Mode pipelines: green and bg (modular and fused), bg_offline, the
person replacement and the evaluation protocol."""

from .green import run as run_green  # noqa: F401
from .bg import run as run_bg  # noqa: F401
from .bg_offline import run as run_bg_offline  # noqa: F401
from .replace import run as run_replace  # noqa: F401
from .evaluate import evaluate_video, run as run_eval  # noqa: F401
from .fused_green import FusedGreenPipeline, run_fused  # noqa: F401
from .fused_bg import FusedBgPipeline  # noqa: F401
