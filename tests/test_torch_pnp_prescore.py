"""The PnP prescore's blind spot (ops/pnp.py solve_pnp_ransac), at the
smallest size that shows it, on the CPU.

RANSAC PnP prescores every hypothesis on the first 256 valid rows and
full-scores the best 384. Registration orders its loose-only rows first, so
where more than 256 of them exist the prescore sees no strict row. Here 300
loose-only rows are junk (no pose explains them) and 200 strict rows follow
the true pose. Of the injected hypotheses 8 are DLT fits to strict rows and
the rest P3P fits to junk rows, each of which explains its own three rows:
the prescore over the junk ranks every junk hypothesis above the true ones,
so the reference's pick is junk and fails. With the strict rows prescored
first (`prescore_strict_first`, the departure registration takes for a
blind pick: pipeline/incremental.py register_view_blind) the same
hypotheses yield the true pose.
"""
import math

import torch

from sfm_danpipeline_torch.ops.pnp import solve_pnp_ransac

N_JUNK, N_TRUE = 300, 200
FOCAL, CX, CY = 500.0, 320.0, 240.0


def _problem():
    g = torch.Generator().manual_seed(7)
    K = torch.tensor([[FOCAL, 0.0, CX], [0.0, FOCAL, CY], [0.0, 0.0, 1.0]])
    a = math.radians(4.0)
    R = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0], [-math.sin(a), 0.0, math.cos(a)]])
    t = torch.tensor([0.2, -0.1, 0.3])
    M = N_JUNK + N_TRUE
    X = torch.cat([
        (torch.rand(M, 2, generator=g) - 0.5) * 4.0, 4.0 + 4.0 * torch.rand(M, 1, generator=g),
    ], dim=1)
    Xc = X @ R.T + t
    px = FOCAL * Xc[:, :2] / Xc[:, 2:] + torch.tensor([CX, CY])
    px = px + 0.3 * torch.randn(M, 2, generator=g)
    # The junk rows: pixels anywhere in the frame, whatever their points.
    px[:N_JUNK] = torch.rand(N_JUNK, 2, generator=g) * torch.tensor([640.0, 480.0])
    xn = (px - torch.tensor([CX, CY])) / FOCAL
    valid = torch.ones(M, dtype=torch.bool)
    strict = torch.arange(M) >= N_JUNK
    idx6 = N_JUNK + torch.stack([torch.randperm(N_TRUE, generator=g)[:6] for _ in range(8)])
    idx3 = torch.stack([torch.randperm(N_JUNK, generator=g)[:3] for _ in range(1024)])
    return X, px, xn, valid, strict, K, (idx6, idx3)


def _solve(strict_first):
    X, px, xn, valid, strict, K, samples = _problem()
    return solve_pnp_ransac(
        None, X, px, xn, valid, K, threshold_px=0.006 * 640, n_hypotheses=1024,
        min_inliers=30, sample_mask=strict, samples=samples, prescore_strict_first=strict_first,
    )


def test_blind_prescore_fails_the_true_pose():
    res = _solve(False)
    assert not bool(res.ok) and int(res.n_inliers) < 30


def test_strict_rows_first_recovers_it_from_the_same_hypotheses():
    res = _solve(True)
    assert bool(res.ok)
    assert int(torch.sum(res.inliers[N_JUNK:])) >= 0.9 * N_TRUE
    assert int(torch.sum(res.inliers[:N_JUNK])) <= 10
