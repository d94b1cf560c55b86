"""video_unscreen_tpu_torch: the PyTorch/CUDA port of video_unscreen_tpu.

A second package beside the JAX one, for one NVIDIA H100 (sm_90a). Plain
tensor code is PyTorch; each Pallas TPU kernel on a ported path is a CUDA
kernel written by hand (`csrc/`, bound in `ops/kernels/`). It imports
torch, numpy and the standard library only.

Ported so far: green-screen unscreen as shipped
(`pipeline/fused_green.py:FusedGreenPipeline`, the DeepLab or chroma
seed), bg mode as shipped (`pipeline/fused_bg.py:FusedBgPipeline`, the
SCHP seed and the STM ring bank) and its modular pipeline
(`pipeline/bg.py:run`), bg_offline, the person replacement, STM training
(`parallel/train_stm.py`), the evaluation protocol
(`pipeline/evaluate.py`) and interactive segmentation
(`agents/iseg.py:ISegAgent`, with BRS).
"""

__version__ = "0.1.0"
