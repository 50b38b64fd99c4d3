"""sfm_danpipeline_torch — the PyTorch/CUDA port of sfm_danpipeline_tpu.

The JAX package `sfm_danpipeline_tpu` is the reference; this package
computes the same incremental Structure-from-Motion main path in PyTorch,
with the top-2 nearest-neighbour matching kernel written by hand in CUDA
for Hopper (csrc/knn2.cu). It never imports JAX.
"""

import torch as _torch

# Precision policy. The reference forces full-f32 matmuls
# (sfm_danpipeline_tpu/__init__.py): the small ill-conditioned systems of
# geometry estimation (8-point DLT, PnP, Schur solves) lose the answer at
# reduced precision. TF32 keeps ~3 decimal digits, so it is off for both
# matmuls and cuDNN convolutions (the SIFT pyramid blur is a convolution).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from sfm_danpipeline_torch.config import (  # noqa: E402
    DEFAULT_CONFIG,
    PipelineConfig,
)

__version__ = "0.1.0"

__all__ = ["DEFAULT_CONFIG", "PipelineConfig", "__version__"]
