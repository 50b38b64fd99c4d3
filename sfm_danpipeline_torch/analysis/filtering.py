"""Point-cloud filtering.

Port of sfm_danpipeline_tpu/analysis/filtering.py, which replaces the
reference's PCL filters (src/Sfm.cpp:1323-1345):
 - PassThrough on x in [0.003, 0.83] (cloudPointFilter, Sfm.cpp:1327-1331)
 - RadiusOutlierRemoval: keep points with >= 150 neighbors within 0.07
   (removePoints, Sfm.cpp:1337-1343)

Masks over fixed-shape tensors; neighbor counting is a chunked
pairwise-distance sweep (one (chunk x N) matrix product per step, no
kd-tree).
"""
from __future__ import annotations

import torch

_AXIS = {"x": 0, "y": 1, "z": 2}


def passthrough_mask(
    points: torch.Tensor,
    axis: str = "x",
    lo: float = 0.003,
    hi: float = 0.83,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """PassThrough filter mask (reference defaults: x in [0.003, 0.83])."""
    a = points[:, _AXIS[axis]]
    m = (a >= lo) & (a <= hi)
    if valid is not None:
        m = m & valid
    return m


def neighbor_counts(
    points: torch.Tensor, valid: torch.Tensor, radius: float, chunk: int = 4096
) -> torch.Tensor:
    """Number of valid neighbors within `radius` of each point (excluding
    itself). points: (N, 3); returns (N,) int32. `chunk` bounds the
    (chunk, N) distance block."""
    r2 = radius * radius
    pn2 = torch.sum(points * points, dim=-1)
    out = []
    for s in range(0, points.shape[0], chunk):
        blk = points[s : s + chunk]
        bval = valid[s : s + chunk]
        d2 = pn2[s : s + chunk, None] + pn2[None, :] - 2.0 * blk @ points.T
        near = (d2 <= r2) & valid[None, :] & bval[:, None]
        # Exclude self-counting (distance ~0 to itself).
        out.append(torch.sum(near, dim=1).to(torch.int32) - bval.to(torch.int32))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32, device=points.device)


def radius_outlier_mask(
    points: torch.Tensor,
    valid: torch.Tensor,
    radius: float = 0.07,
    min_neighbors: int = 150,
) -> torch.Tensor:
    """RadiusOutlierRemoval mask (reference: r=0.07, >=150 neighbors)."""
    counts = neighbor_counts(points, valid, radius)
    return valid & (counts >= min_neighbors)
