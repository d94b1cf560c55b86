"""Pipeline stages: seeds, colour filtering, STM, trimap, matting, the
background model, harmonization and interactive segmentation."""

from .colorfiltering import ColorFilteringAgent  # noqa: F401
from .trimap import TrimapAgent  # noqa: F401
from .bgmodel import BackgroundAgent  # noqa: F401
from .harmonization import HarmonizationAgent  # noqa: F401
from .binseg import SegAgent, HumanSegAgent, ChromaSegAgent  # noqa: F401
from .vmatting import VMattingAgent  # noqa: F401
from .stm import STMAgent  # noqa: F401
from .iseg import ISegAgent  # noqa: F401
