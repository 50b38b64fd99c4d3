"""Chordal (L2) rotation averaging and translation averaging.

Port of sfm_danpipeline_tpu/ops/rotavg.py. Minimizing
    sum_ij w_ij ||R_j - R_ij R_i||_F^2
over stacked X = [R_0; ...; R_{V-1}] (3V, 3) is the quadratic form
X^T L X with the block connection Laplacian
    L_ii = (sum_j w_ij) I_3,   L_ij = -w_ij R_ij^T ;
its bottom-3 eigenvectors solve the orthogonality-relaxed problem, and a
per-block SVD projection returns to SO(3).

The Laplacians are assembled by contracting one-hot edge-incidence
matrices with the per-edge 3x3 blocks (plain GEMMs) instead of an atomic
scatter-add, so the result does not depend on the order in which a card
accumulates duplicate edges.

Convention: R_i is world-to-camera; R_ij maps camera-i coordinates to
camera-j (R_ij = R_j R_i^T), matching ops/epipolar's relative pose.
"""
from __future__ import annotations

from typing import Tuple

import torch


def project_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation(s) in Frobenius norm: U diag(1,1,det(UV^T)) V^T,
    batched over leading dims."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def _block_laplacian(
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    B_ii: torch.Tensor,  # (P, 3, 3) added to block (i, i)
    B_jj: torch.Tensor,
    B_ij: torch.Tensor,  # added to block (i, j)
    B_ji: torch.Tensor,
    n_views: int,
) -> torch.Tensor:
    """(3V, 3V) sum of per-edge 3x3 blocks at (i,i), (j,j), (i,j), (j,i)."""
    Ei = torch.nn.functional.one_hot(pair_i.long(), n_views).to(B_ij.dtype)  # (P, V)
    Ej = torch.nn.functional.one_hot(pair_j.long(), n_views).to(B_ij.dtype)
    L = (
        torch.einsum("pa,pb,pxy->axby", Ei, Ei, B_ii)
        + torch.einsum("pa,pb,pxy->axby", Ej, Ej, B_jj)
        + torch.einsum("pa,pb,pxy->axby", Ei, Ej, B_ij)
        + torch.einsum("pa,pb,pxy->axby", Ej, Ei, B_ji)
    )
    return L.reshape(3 * n_views, 3 * n_views)


def average_rotations(
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    R_rel: torch.Tensor,
    weights: torch.Tensor,
    n_views: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute rotations from relative measurements.

    pair_i, pair_j: (P,) view indices (i -> j edges); R_rel: (P, 3, 3)
    measured R_ij; weights: (P,), 0 disables an edge.

    Returns (R (V, 3, 3) world-to-camera, gauge-fixed so R[0] = I;
    residual (P,) chordal error ||R_j - R_ij R_i||_F per edge). Views
    untouched by any positive-weight edge come back as arbitrary rotations.
    """
    V = n_views
    w = weights.to(torch.float32)
    dev = w.device
    I3 = torch.eye(3, dtype=torch.float32, device=dev)
    deg = w[:, None, None] * I3[None]
    off = -w[:, None, None] * R_rel.transpose(-1, -2)  # -w R_ij^T
    Lm = _block_laplacian(pair_i, pair_j, deg, deg, off, off.transpose(-1, -2), V)
    # Tiny ridge keeps eigh well-posed when the graph is disconnected.
    Lm = Lm + 1e-9 * torch.eye(3 * V, dtype=torch.float32, device=dev)
    _, vecs = torch.linalg.eigh(Lm)
    X = vecs[:, :3].reshape(V, 3, 3)  # bottom-3 eigenvectors, blocks X_i
    # The basis is defined up to an orthogonal mixing G (X_i ~ R_i G); when
    # det(G) = -1 the per-block projection would flip blocks inconsistently,
    # so negate one eigenvector when most block determinants are negative.
    s = torch.sign(torch.sum(torch.sign(torch.linalg.det(X))))
    s = torch.where(s == 0, torch.ones_like(s), s)
    X = torch.cat([X[..., :2], X[..., 2:] * s], dim=-1)
    R = project_so3(X)
    # Gauge: view 0 is the identity.
    R = R @ R[0].T[None]
    res = R[pair_j.long()] - torch.einsum("pab,pbc->pac", R_rel, R[pair_i.long()])
    return R, torch.sqrt(torch.sum(res * res, dim=(-2, -1)))


def average_translations(
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    R_abs: torch.Tensor,  # (V, 3, 3) absolute world->cam rotations
    t_rel: torch.Tensor,  # (P, 3) relative translations (x_j = R_ij x_i + t)
    weights: torch.Tensor,  # (P,)
    n_views: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera centers from pairwise baseline directions, given absolute
    rotations. Each edge constrains C_j - C_i to be parallel to
    d_ij = -R_j^T t_ij; eliminating the per-edge scale gives
    sum_ij w ||(I - d d^T)(C_j - C_i)||^2, a 3x3-block graph Laplacian. A
    mean-center penalty deflates the global translations, leaving the
    centers as the bottom eigenvector.

    Returns (C (V, 3) centers up to sign and scale, mean 0, unit norm;
    residual (P,) per-edge perpendicular error at that scale)."""
    V = n_views
    w = weights.to(torch.float32)
    dev = w.device
    pj = pair_j.long()
    d = -torch.einsum("pba,pb->pa", R_abs[pj], t_rel)
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    M = torch.eye(3, device=dev)[None] - d[:, :, None] * d[:, None, :]
    Mw = w[:, None, None] * M
    Lm = _block_laplacian(pair_i, pair_j, Mw, Mw, -Mw, -Mw, V)
    # Deflate the global-translation nullspace: (T C) is the mean per block.
    T = torch.eye(3, device=dev).repeat(V, V) / V
    scale = torch.trace(Lm) / (3 * V) + 1e-6
    Lm = Lm + scale * T
    _, vecs = torch.linalg.eigh(Lm + 1e-9 * torch.eye(3 * V, device=dev))
    C = vecs[:, 0].reshape(V, 3)
    C = C - torch.mean(C, dim=0, keepdim=True)
    C = C / (torch.linalg.norm(C) + 1e-12)
    perp = torch.einsum("pab,pb->pa", M, C[pj] - C[pair_i.long()])
    return C, torch.linalg.norm(perp, dim=-1)
