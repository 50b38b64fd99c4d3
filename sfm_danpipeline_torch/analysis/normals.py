"""Point-cloud normal estimation.

Port of sfm_danpipeline_tpu/analysis/normals.py, which replaces PCL's
NormalEstimationOMP (k=10; src/Sfm.cpp:1347-1358) with a batched kNN-PCA:
covariance of each point's k nearest neighbors, normal = the eigenvector of
the smallest eigenvalue, flipped toward the viewpoint like the reference's
flip loop (src/Sfm.cpp:1353-1358). The reference finds that eigenvector by
48 power iterations (a workaround for a slow small-eigh path); here it is
one batched `torch.linalg.eigh` on the 3x3 covariances.
"""
from __future__ import annotations

import torch

from sfm_danpipeline_torch.analysis.segmentation import knn_indices


def estimate_normals(
    points: torch.Tensor,
    valid: torch.Tensor,
    viewpoint: torch.Tensor | None = None,
    k: int = 10,
) -> torch.Tensor:
    """(N, 3) unit normals. viewpoint defaults to the origin (PCL default)."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=points.dtype, device=points.device)
    nbr = knn_indices(points, valid, k=k).long()
    nb = points[nbr]  # (N, k, 3)
    d = nb - torch.mean(nb, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", d, d) / k
    n = torch.linalg.eigh(cov).eigenvectors[..., 0]  # ascending eigenvalues
    # Flip toward viewpoint (src/Sfm.cpp:1353-1358).
    sign = torch.sign(torch.sum(n * (viewpoint[None, :] - points), dim=-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return n * sign
