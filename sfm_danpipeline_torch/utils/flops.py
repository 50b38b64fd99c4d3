"""FLOPs models for the hot stages: analytic counts of the arithmetic the
algorithms require, so measured time against the model gives a
model-FLOPs utilization (MFU). The SIFT stages are gather-bound (low
arithmetic intensity); matching is the multiply-add workload.
"""
from __future__ import annotations

import math

from sfm_danpipeline_torch.config import FeatureConfig, MatchConfig

# Published float32 multiply-add peak of one NVIDIA H100 SXM outside the
# tensor cores, at its full 700 W power limit (the matching kernel's
# arithmetic is plain fp32).
H100_PEAK_F32 = 67.0e12


def sift_flops(h: int, w: int, config: FeatureConfig = FeatureConfig()) -> float:
    """Arithmetic of one image's detect+describe (pyramid convolutions +
    orientation/descriptor sampling)."""
    if config.upsample:
        h, w = 2 * h, 2 * w
    flops = 0.0
    k = 2.0 ** (1.0 / config.n_scales_per_octave)
    for o in range(config.n_octaves):
        hh, ww = h >> o, w >> o
        sp = config.sigma0
        for i in range(1, config.n_scales_per_octave + 3):
            st = config.sigma0 * (k ** i)
            si = math.sqrt(max(st * st - sp * sp, 1e-12))
            taps = 2 * max(1, int(math.ceil(3.0 * si))) + 1
            flops += 2.0 * 2 * taps * hh * ww  # separable, MAC = 2 flops
            sp = st
        # DoG + extrema reduce_window: ~30 flops/voxel over S+2 levels.
        flops += 30.0 * (config.n_scales_per_octave + 2) * hh * ww
    # Orientation (K candidates x 256 samples) + descriptors (2K rows):
    # bilinear gather (8 flops) x 2 gradients + ~20 flops of binning math.
    K = config.max_keypoints
    flops += (K + 2 * K) * 256.0 * (2 * 8 + 20)
    return flops


def matching_flops(
    n_pairs: int, k: int = 2048, d: int = 128
) -> float:
    """All-pairs descriptor distance: one K x K x D matmul per pair."""
    return 2.0 * n_pairs * k * k * d


def mfu(flops: float, seconds: float, peak: float = H100_PEAK_F32) -> float:
    """Model-FLOPs utilization in [0, 1]."""
    return flops / max(seconds, 1e-12) / peak
