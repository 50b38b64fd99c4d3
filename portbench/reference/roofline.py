"""Peaks of the card and the work of the program's kernels.

The least time a kernel's launch could take on an H100 is the larger of its
operations over the peak rate and its bytes over the peak bandwidth; its
roofline share is that time over the kernel's device time.

Peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W limit):
- FP32_ACCURATE_FLOPS: 165 TFLOP/s, the fastest float32-accurate route,
  3xTF32 on the tensor cores (495 / 3). The plain fp32 FMA rate (67 TFLOP/s,
  the count in sfm_danpipeline_torch/utils/flops.py and chip_smoke.py) caps
  only one way of doing the arithmetic; against 165 no float32-accurate
  implementation can read over 100%.
- HBM_BYTES_PER_S: 3.35 TB/s.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

FP32_ACCURATE_FLOPS = 165.0e12
HBM_BYTES_PER_S = 3.35e12


def knn2_work(valid_rows: Sequence[int], D: int, K: int):
    """(operations, bytes) of one knn2 launch over every pair i < j of the
    images, as `match_all_pairs` gives them to it.

    Operations: 2 * D per distance, over the valid A rows times the valid B
    rows of each pair (what these inputs need, not the padded K x K).
    Bytes: each input read once (descriptors (N, K, D) f32, valid (N, K) u8,
    xy (N, K, 2) f32, the two (P,) i32 pair lists) and each output written
    once (index, best and second distance, (P, K) 4 bytes each)."""
    n = np.asarray(valid_rows, np.float64)
    N = len(n)
    P = N * (N - 1) // 2
    pairs = (n.sum() ** 2 - (n * n).sum()) / 2.0  # sum over i < j of n_i * n_j
    flops = 2.0 * D * pairs
    nbytes = N * K * (4 * D + 1 + 8) + 2 * 4 * P + 3 * 4 * P * K
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the work can take on the card."""
    return max(flops / FP32_ACCURATE_FLOPS, nbytes / HBM_BYTES_PER_S)
