"""Dendrometry: tree-measurement estimates from a segmented cloud.

Port of sfm_danpipeline_tpu/analysis/dendrometry.py, which replaces
`Dendrometry::estimate` (src/DendrometryE.cpp:3-29): the reference computes
getMinMax3D and prints Total height = ||max - min||, with the remaining
measures (trunk height, crown height, DBH/DAP, crown diameter) printed as
empty placeholders. This computes the same total height plus values for the
placeholder measures (axis-aligned heights, a breast-height diameter slice).
"""
from __future__ import annotations

from typing import Dict

import torch


def estimate(points: torch.Tensor, valid: torch.Tensor) -> Dict[str, float]:
    """Dendrometry measures of a (masked) point cloud.

    Returns a dict with the reference's headline `total_height`
    (||max - min||, src/DendrometryE.cpp:17-21) and filled-in versions of
    its placeholder measures. The vertical axis is the one with the largest
    extent (turntable clouds are not gravity-aligned)."""
    big = 3.4e38
    hi_fill = torch.full_like(points, big)
    lo_fill = torch.full_like(points, -big)
    mn = torch.min(torch.where(valid[:, None], points, hi_fill), dim=0).values
    mx = torch.max(torch.where(valid[:, None], points, lo_fill), dim=0).values
    extent = mx - mn
    diag = torch.linalg.norm(extent)
    up = int(torch.argmax(extent))
    height = extent[up]
    # Breast-height diameter: spread of the slice 8-12% above the base along
    # the vertical axis (the reference's DAP placeholder,
    # src/DendrometryE.cpp:24).
    rel = (points[:, up] - mn[up]) / torch.clamp(height, min=1e-9)
    slice_mask = (valid & (rel >= 0.08) & (rel <= 0.12))[:, None]
    sl_lo = torch.min(torch.where(slice_mask, points, hi_fill), dim=0).values
    sl_hi = torch.max(torch.where(slice_mask, points, lo_fill), dim=0).values
    sl_extent = torch.clamp(sl_hi - sl_lo, min=0.0)
    dbh = (torch.sum(sl_extent) - sl_extent[up]) / 2.0
    return {
        "total_height": float(diag),
        "axis_height": float(height),
        "trunk_height": float(0.4 * height),
        "crown_height": float(0.6 * height),  # crown assumed upper 60%
        "dbh": float(dbh),
        "n_points": float(torch.sum(valid.to(torch.int32))),
        "min": [float(v) for v in mn],
        "max": [float(v) for v in mx],
    }
