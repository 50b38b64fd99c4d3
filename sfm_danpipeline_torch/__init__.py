"""sfm_danpipeline_torch — the PyTorch/CUDA port of sfm_danpipeline_tpu.

The JAX package `sfm_danpipeline_tpu` is the reference; this package
computes the same incremental Structure-from-Motion pipeline in PyTorch
(sparse and dense reconstruction, cloud analysis, meshing, and the
command line `python -m sfm_danpipeline_torch.cli`), with the top-2
nearest-neighbour matching kernel written by hand in CUDA for Hopper
(csrc/knn2.cu). It never imports JAX.
"""

import torch as _torch

# Precision policy. The reference forces full-f32 matmuls
# (sfm_danpipeline_tpu/__init__.py): the small ill-conditioned systems of
# geometry estimation (8-point DLT, PnP, Schur solves) lose the answer at
# reduced precision. TF32 keeps ~3 decimal digits, so it is off for both
# matmuls and cuDNN convolutions (the SIFT pyramid blur is a convolution).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def require_device(device) -> _torch.device:
    """Device policy: the device an entry point runs on (`device` a str or
    a torch.device) is the CUDA card unless the caller asks for the CPU.
    Raises when a card is asked for and none is present, instead of running
    on the CPU unasked."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "sfm_danpipeline_torch runs on a CUDA card by default and none is "
            'available; pass device="cpu" to run on the CPU'
        )
    return dev


from sfm_danpipeline_torch.config import (  # noqa: E402
    DEFAULT_CONFIG,
    PipelineConfig,
)

__version__ = "0.1.0"

__all__ = ["DEFAULT_CONFIG", "PipelineConfig", "require_device", "__version__"]
