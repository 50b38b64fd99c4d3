"""A plain float64 bundle adjustment: how far a reconstruction's cameras and
points are from a least-squares optimum of its own reprojection cost.

Levenberg-Marquardt with the points eliminated (Schur complement), numpy
only. The cost is the program's BA objective, 0.5 * sum of squared pixel
residuals of every observation, with the focal length held (the program's
default, `ba.optimize_focal=False`) and the first camera held, which fixes
all of the gauge but the scale (LM's damping takes that). Cameras move as
R <- exp(d_theta) R, t <- t + d_t, points as X <- X + d_X.
"""
from __future__ import annotations

import numpy as np


def _hat(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = np.zeros(v.shape[:-1])
    return np.stack([
        np.stack([z, -v[..., 2], v[..., 1]], -1),
        np.stack([v[..., 2], z, -v[..., 0]], -1),
        np.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _exp(w):
    """Angle-axis (..., 3) -> rotations (..., 3, 3)."""
    theta = np.linalg.norm(w, axis=-1)[..., None, None]
    K = _hat(w / np.maximum(theta[..., 0], 1e-300))
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


class Problem:
    """Observations `obs_v` (views), `obs_n` (points) with pixels `xy`
    (O, 2), sorted by point; cameras R (V, 3, 3), t (V, 3); points (N, 3);
    focal f and principal point pp (2,)."""

    def __init__(self, R, t, X, obs_v, obs_n, xy, f, pp):
        self.R, self.t, self.X = R.astype(np.float64), t.astype(np.float64), X.astype(np.float64)
        self.obs_v, self.obs_n = obs_v, obs_n
        self.xy = xy.astype(np.float64)
        self.f, self.pp = float(f), np.asarray(pp, np.float64)

    def residuals(self, R, t, X):
        p = np.einsum("oij,oj->oi", R[self.obs_v], X[self.obs_n]) + t[self.obs_v]
        return self.f * p[:, :2] / p[:, 2:3] + self.pp - self.xy

    def cost(self, R, t, X) -> float:
        r = self.residuals(R, t, X)
        return 0.5 * float(np.sum(r * r))

    def step(self, R, t, X, lam: float, fixed: int):
        """One damped Gauss-Newton step; returns the moved (R, t, X)."""
        V, N = len(R), len(X)
        v, n = self.obs_v, self.obs_n
        q = np.einsum("oij,oj->oi", R[v], X[n])
        p = q + t[v]
        iz = 1.0 / p[:, 2]
        Jproj = np.zeros((len(p), 2, 3))
        Jproj[:, 0, 0] = Jproj[:, 1, 1] = self.f * iz
        Jproj[:, 0, 2] = -self.f * p[:, 0] * iz * iz
        Jproj[:, 1, 2] = -self.f * p[:, 1] * iz * iz
        r = self.f * p[:, :2] * iz[:, None] + self.pp - self.xy
        Jc = np.concatenate([-Jproj @ _hat(q), Jproj], -1)  # (O, 2, 6)
        Jp = Jproj @ R[v]  # (O, 2, 3)
        U = np.zeros((V, 6, 6))
        np.add.at(U, v, np.einsum("oki,okj->oij", Jc, Jc))
        Vp = np.zeros((N, 3, 3))
        np.add.at(Vp, n, np.einsum("oki,okj->oij", Jp, Jp))
        W = np.einsum("oki,okj->oij", Jc, Jp)  # (O, 6, 3)
        gc = np.zeros((V, 6))
        np.add.at(gc, v, np.einsum("oki,ok->oi", Jc, r))
        gp = np.zeros((N, 3))
        np.add.at(gp, n, np.einsum("oki,ok->oi", Jp, r))
        eye3 = np.eye(3)
        Vd = Vp + lam * (Vp * eye3) + 1e-12 * eye3
        Vinv = np.linalg.inv(Vd)
        Y = W @ Vinv[n]  # (O, 6, 3)
        # S = blockdiag(U + lam diag U) - sum over points of Y_a W_b^T.
        Yf = np.zeros((N, V, 6, 3))
        Wf = np.zeros((N, V, 6, 3))
        Yf[n, v], Wf[n, v] = Y, W
        Yf = Yf.reshape(N, V * 6, 3).transpose(1, 0, 2).reshape(V * 6, N * 3)
        Wf = Wf.reshape(N, V * 6, 3).transpose(1, 0, 2).reshape(V * 6, N * 3)
        S = -(Yf @ Wf.T)
        Ud = U + lam * (U * np.eye(6))
        for i in range(V):
            S[6 * i:6 * i + 6, 6 * i:6 * i + 6] += Ud[i]
        b = -gc.reshape(-1)
        np.add.at(b.reshape(V, 6), v, np.einsum("oij,oj->oi", Y, gp[n]))
        free = np.ones(V * 6, bool)
        free[6 * fixed:6 * fixed + 6] = False
        dc = np.zeros(V * 6)
        dc[free] = np.linalg.solve(S[np.ix_(free, free)], b[free])
        dc = dc.reshape(V, 6)
        rhs = -gp.copy()
        np.add.at(rhs, n, -np.einsum("oij,oi->oj", W, dc[v]))
        dX = np.einsum("nij,nj->ni", Vinv, rhs)
        return _exp(dc[:, :3]) @ R, t + dc[:, 3:], X + dX


def refine(prob: Problem, fixed: int = 0, iterations: int = 30):
    """LM from the problem's own cameras and points; returns (initial cost,
    final cost)."""
    R, t, X = prob.R, prob.t, prob.X
    c0 = cost = prob.cost(R, t, X)
    lam = 1e-4
    for _ in range(iterations):
        R1, t1, X1 = prob.step(R, t, X, lam, fixed)
        c1 = prob.cost(R1, t1, X1)
        if c1 < cost:
            done = (cost - c1) <= 1e-12 * cost
            R, t, X, cost, lam = R1, t1, X1, c1, max(lam / 10.0, 1e-12)
            if done:
                break
        else:
            lam *= 10.0
            if lam > 1e8:
                break
    return c0, cost
