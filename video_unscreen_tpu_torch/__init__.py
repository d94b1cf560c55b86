"""video_unscreen_tpu_torch: the PyTorch/CUDA port of video_unscreen_tpu.

A second package beside the JAX one, for one NVIDIA H100 (sm_90a). Plain
tensor code is PyTorch; each Pallas TPU kernel on a ported path is a CUDA
kernel written by hand (`csrc/`, bound in `ops/kernels/`). It imports
torch, numpy and the standard library only.

Ported so far: green-screen unscreen with the chroma seed
(`pipeline/fused_green.py:FusedGreenPipeline`).
"""

__version__ = "0.1.0"
