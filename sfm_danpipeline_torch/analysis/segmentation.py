"""Color-based region-growing segmentation.

Port of sfm_danpipeline_tpu/analysis/segmentation.py, which replaces
`Segmentation::color_based_growing_segmentation`
(src/Segmentation.cpp:3-66): PassThrough z in [0, 14], PCL RegionGrowingRGB
(distance 10, point-color 6, region-color 5, min cluster 600), abort when
zero clusters.

Region growing == connected components of the graph whose edges join points
within `distance` AND within `point_color` RGB distance. A kNN adjacency
(chunked pairwise sweep) and iterative min-label propagation to a fixed
point (a host loop) give a deterministic equivalent of PCL's queue-based
growth. PCL's second-stage region merging by average color
(`region_color`) is applied afterwards on the cluster graph. Colors are in
PCL's 0-255 scale for threshold parity. Labels are exact integers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_danpipeline_torch.ops.reduce import planned_sum, segment_plan
from sfm_danpipeline_torch.ops.select import top_k_indices


class SegmentationResult(NamedTuple):
    labels: torch.Tensor  # (N,) int32 cluster label per point (-1 = dropped)
    n_clusters: torch.Tensor  # () int32: clusters >= min_cluster_size


def knn_indices(
    points: torch.Tensor, valid: torch.Tensor, k: int = 16, chunk: int = 2048
) -> torch.Tensor:
    """Indices (N, k) int32 of the k nearest valid neighbors per point (self
    excluded). Equal distances keep the lower index first."""
    N = points.shape[0]
    pn2 = torch.sum(points * points, dim=-1)
    big = 3.4e38
    cols = torch.arange(N, device=points.device)
    out = []
    for s in range(0, N, chunk):
        blk = points[s : s + chunk]
        d2 = pn2[s : s + chunk, None] + pn2[None, :] - 2.0 * blk @ points.T
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, big))
        d2 = torch.where(cols[s : s + chunk, None] == cols[None, :], torch.full_like(d2, big), d2)
        out.append(top_k_indices(-d2, k))
    return torch.cat(out).to(torch.int32)


def _propagate_min_labels(labels, nbr, edge, N: int):
    """Min-label propagation over the symmetric closure of `edge` to a fixed
    point: each round pulls the smallest neighbour label and pushes the own
    label to the neighbours (a scatter-min, which is order-independent)."""
    sentinel = torch.full_like(nbr, N)
    tgt = torch.where(edge, nbr, sentinel).reshape(-1)
    while True:
        nbr_lab = torch.where(edge, labels[nbr], sentinel)
        pulled = torch.minimum(labels, torch.min(nbr_lab, dim=1).values)
        pushed = torch.full((N + 1,), N, dtype=labels.dtype, device=labels.device)
        pushed = pushed.scatter_reduce(
            0, tgt, labels[:, None].expand_as(nbr).reshape(-1), "amin"
        )
        new = torch.minimum(pulled, pushed[:N])
        if not bool(torch.any(new != labels)):
            return new
        labels = new


def region_growing_rgb(
    points: torch.Tensor,
    colors255: torch.Tensor,
    valid: torch.Tensor,
    distance: float = 10.0,
    point_color: float = 6.0,
    region_color: float = 5.0,
    min_cluster: int = 600,
    k: int = 16,
) -> SegmentationResult:
    """RegionGrowingRGB with the reference's thresholds
    (src/Segmentation.cpp:29-35). colors255: (N, 3) in [0, 255]."""
    N = points.shape[0]
    dev = points.device
    nbr = knn_indices(points, valid, k=k).long()  # (N, k)

    d = points[nbr] - points[:, None, :]
    dist_ok = torch.sum(d * d, dim=-1) <= distance * distance
    dc = colors255[nbr] - colors255[:, None, :]
    color_ok = torch.sum(torch.abs(dc), dim=-1) / 3.0 <= point_color
    both_valid = valid[:, None] & valid[nbr]
    edge = dist_ok & color_ok & both_valid

    ids = torch.arange(N, dtype=torch.int64, device=dev)
    init = torch.where(valid, ids, torch.full_like(ids, N))
    labels = _propagate_min_labels(init, nbr, edge, N)

    # Region merging by average color (PCL stage 2): clusters whose mean
    # colors differ < region_color and that touch (share a kNN edge) merge.
    # The colour sums use the order-fixed segment sum: a float scatter-add
    # would differ in the last bits between runs on a card and could flip a
    # merge decision.
    zero3 = torch.zeros_like(colors255)
    by_label = segment_plan(labels, N + 1)
    seg_sum = planned_sum(torch.where(valid[:, None], colors255, zero3), by_label)
    seg_cnt = planned_sum(valid.to(torch.float32), by_label)
    seg_mean = seg_sum / torch.clamp(seg_cnt[:, None], min=1.0)
    touching = edge | (dist_ok & both_valid)
    mean_diff = torch.sum(torch.abs(seg_mean[labels][:, None, :] - seg_mean[labels[nbr]]), dim=-1) / 3.0
    merge_edge = touching & (mean_diff <= region_color)
    labels = _propagate_min_labels(labels, nbr, merge_edge, N)

    # Cluster size filter (min 600, src/Segmentation.cpp:35). Integer
    # counts: any summation order gives the same result.
    sizes = torch.zeros((N + 1,), dtype=torch.int64, device=dev).index_add_(
        0, labels, valid.to(torch.int64)
    )
    keep = valid & (sizes[labels] >= min_cluster)
    labels = torch.where(keep, labels, torch.full_like(labels, -1))
    # Count surviving clusters (distinct root labels).
    n_clusters = torch.sum(keep & (labels == ids)).to(torch.int32)
    return SegmentationResult(labels=labels.to(torch.int32), n_clusters=n_clusters)


def segment_cloud(
    points: torch.Tensor,
    colors01: torch.Tensor,
    valid: torch.Tensor,
    z_min: float = 0.0,
    z_max: float = 14.0,
    **kwargs,
) -> SegmentationResult:
    """Full reference flow: PassThrough z in [0,14] (Segmentation.cpp:24-28)
    then RegionGrowingRGB. colors01 in [0,1] are rescaled to PCL's 0-255."""
    zmask = (points[:, 2] >= z_min) & (points[:, 2] <= z_max) & valid
    return region_growing_rgb(points, colors01 * 255.0, zmask, **kwargs)
