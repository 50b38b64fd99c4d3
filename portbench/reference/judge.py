"""The comparison that decides `correct`: a reconstruction against the exact
scene it was made from.

Plain numpy (and the scene's float64 ray cast); imports nothing of the
program. The program's outputs are only read here: its registered cameras,
focal length, sparse points with their observations (feature ids into its
keypoints), and its ratio-test matches. A cell's limits file says which
numbers are compared and whether each is held to a "max" or a "min";
`compare` takes the worst over the sets of a run.

- views_missing: views of the set that are not registered.
- ate_pct: camera centers after the least-squares similarity onto the true
  centers, RMS error over the diameter of the true trajectory, in %.
- rot_err_deg: largest angle between a registered camera's rotation, carried
  into the true frame, and its true rotation. The similarity into the true
  frame takes its rotation from the cameras' rotations (their chordal mean)
  and its scale and shift from the centers.
- reproj_rms_px: RMS reprojection error of every observation of every point
  in the program's own cameras, recomputed in float64.
- ba_excess_px2: how far the program's cameras and points are from an
  optimum of their own reprojection cost: what a float64 bundle adjustment
  (reference/ba.py) started from them still removes of the cost
  0.5 * sum |r|^2, per observation, in px^2.
- match_outlier_pct: share of the matches that pass the ratio test (every
  pair of views) whose keypoint in the second view lies more than TRACK_PX
  from the true transfer of its keypoint in the first: the first keypoint
  is cast onto the room and projected into the second view. This is what
  features and matching hand to the rest of the pipeline.
- track_outlier_pct: the same for the map: share of the later observations
  of a track that lie more than TRACK_PX from the true transfer of its
  first observation.
- point_p95_pct: 95th percentile, over the sparse points carried into the
  true frame, of their distance to the room's surface over their distance
  from the ring's center, in %.
- n_points: the sparse points.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from portbench.reference import ba
from portbench.reference.align import aligned_rmse, rodrigues
from portbench.reference.scene import Scene, surface_distance

TRACK_PX = 2.0


@dataclasses.dataclass
class Reconstruction:
    """One set's outputs, on the host."""

    cameras: np.ndarray  # (V, 6) angle-axis + t, world->camera
    camera_valid: np.ndarray  # (V,) bool
    focal: float
    points: np.ndarray  # (N, 3) the valid sparse points
    tracks: np.ndarray  # (N, V) int32 feature id per view, -1 where none
    kp_xy: np.ndarray  # (V, K, 2) keypoint pixels
    # The ratio-test matches of every pair of views: the pairs (P, 2), and
    # per pair (P, M) the feature ids in its first and second view and
    # whether the slot holds a match.
    match_pairs: Optional[np.ndarray] = None
    match_a: Optional[np.ndarray] = None
    match_b: Optional[np.ndarray] = None
    match_valid: Optional[np.ndarray] = None

    def digest(self) -> int:
        """Hash of every array, so equal outputs are judged once."""
        parts = [self.cameras, self.camera_valid, np.float64(self.focal), self.points, self.tracks, self.kp_xy]
        parts += [p for p in (self.match_pairs, self.match_a, self.match_b, self.match_valid) if p is not None]
        return hash(b"".join(np.ascontiguousarray(p).tobytes() for p in parts))


def project_so3(M: np.ndarray) -> np.ndarray:
    """The rotation nearest to M (3, 3) in the Frobenius norm."""
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def _percentile(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) if len(x) else float("inf")


def transfer_error(scene: Scene, src: np.ndarray, xy_src: np.ndarray, dst: np.ndarray, xy_dst: np.ndarray):
    """Pixel distance (N,) between `xy_dst` in views `dst` and the true
    projection there of the scene points seen at `xy_src` in views `src`."""
    X = np.zeros((len(src), 3))
    for u in np.unique(src):
        sel = src == u
        X[sel] = scene.world_points(int(u), xy_src[sel])
    q = np.einsum("oij,oj->oi", scene.R[dst], X) + scene.t[dst]
    true_xy = (q[:, :2] / q[:, 2:3]) * scene.K[[0, 1], [0, 1]] + scene.K[[0, 1], [2, 2]]
    return np.linalg.norm(true_xy - xy_dst, axis=-1)


def match_outlier_pct(rec: Reconstruction, scene: Scene) -> float:
    """Share of the ratio-test matches off their true transfer (%)."""
    p, m = np.nonzero(rec.match_valid)
    if not len(p):
        return float("inf")
    vi, vj = rec.match_pairs[p, 0], rec.match_pairs[p, 1]
    xa = rec.kp_xy[vi, rec.match_a[p, m]].astype(np.float64)
    xb = rec.kp_xy[vj, rec.match_b[p, m]].astype(np.float64)
    return 100.0 * float(np.mean(transfer_error(scene, vi, xa, vj, xb) > TRACK_PX))


def judge(rec: Reconstruction, scene: Scene) -> Dict[str, float]:
    """The numbers of one set (see the module docstring)."""
    V = scene.n_views
    reg = np.flatnonzero(rec.camera_valid)
    out = {"views_missing": float(V - len(reg))}
    if rec.match_valid is not None:
        out["match_outlier_pct"] = match_outlier_pct(rec, scene)
    if len(reg) < 3 or len(rec.points) == 0:
        inf = float("inf")
        out.update(ate_pct=inf, rot_err_deg=inf, reproj_rms_px=inf, ba_excess_px2=inf, track_outlier_pct=inf,
                   point_p95_pct=inf)
        return out
    R_est = rodrigues(rec.cameras[:, :3])
    t_est = rec.cameras[:, 3:].astype(np.float64)
    C_est = -np.einsum("vji,vj->vi", R_est, t_est)
    diameter = float(np.max(np.linalg.norm(scene.centers[:, None] - scene.centers[None], axis=-1)))
    out["ate_pct"] = 100.0 * aligned_rmse(C_est[reg], scene.centers[reg]) / diameter
    # The similarity into the true frame from the cameras' rotations and
    # centers together (X_true = s Ra X + ta, R_true = R Ra^T): on a short
    # arc the centers alone leave the turn about their line all but free.
    Ra = project_so3(np.einsum("vji,vjk->ik", scene.R[reg], R_est[reg]))
    Y = C_est[reg] @ Ra.T
    Yc, Cc = Y - Y.mean(0), scene.centers[reg] - scene.centers[reg].mean(0)
    s = float(np.sum(Yc * Cc) / np.sum(Yc * Yc))
    ta = scene.centers[reg].mean(0) - s * Y.mean(0)
    rel = np.einsum("vij,vkj->vik", scene.R[reg], R_est[reg] @ Ra.T)  # R_true (R Ra^T)^T
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    out["rot_err_deg"] = float(np.degrees(np.arccos(cos)).max())

    # Observations of registered views: (point, view, feature).
    obs_n, obs_v = np.nonzero((rec.tracks >= 0) & rec.camera_valid[None, :])
    obs_f = rec.tracks[obs_n, obs_v]
    xy = rec.kp_xy[obs_v, obs_f].astype(np.float64)
    X = rec.points.astype(np.float64)[obs_n]
    p = np.einsum("oij,oj->oi", R_est[obs_v], X) + t_est[obs_v]
    pred = rec.focal * p[:, :2] / p[:, 2:3] + scene.K[[0, 1], [2, 2]]
    err = np.linalg.norm(pred - xy, axis=-1)
    out["reproj_rms_px"] = float(np.sqrt(np.mean(err**2))) if len(err) else float("inf")
    remap = np.cumsum(rec.camera_valid) - 1  # view -> index among the registered
    c0, c_min = ba.refine(ba.Problem(
        R_est[reg], t_est[reg], rec.points, remap[obs_v], obs_n, xy, rec.focal, scene.K[[0, 1], [2, 2]]
    ))
    out["ba_excess_px2"] = (c0 - c_min) / len(obs_n)

    # True transfer of each track's first observation to its later ones.
    first = np.ones(len(obs_n), bool)
    first[1:] = obs_n[1:] != obs_n[:-1]  # np.nonzero is row-major: sorted by point
    head = np.maximum.accumulate(np.where(first, np.arange(len(obs_n)), 0))[~first]
    later = np.flatnonzero(~first)
    transfer = transfer_error(scene, obs_v[head], xy[head], obs_v[later], xy[later])
    out["track_outlier_pct"] = 100.0 * float(np.mean(transfer > TRACK_PX)) if len(transfer) else 0.0

    Xg = s * (rec.points.astype(np.float64) @ Ra.T) + ta
    out["point_p95_pct"] = 100.0 * _percentile(surface_distance(Xg) / np.linalg.norm(Xg, axis=-1), 95.0)
    out["n_points"] = float(len(rec.points))
    return out


def judge_each(recs, scene: Scene) -> List[Dict[str, float]]:
    """The numbers of each set; equal outputs are judged once."""
    seen: Dict[int, Dict[str, float]] = {}
    for rec in recs:
        key = rec.digest()
        if key not in seen:
            seen[key] = judge(rec, scene)
    return [seen[rec.digest()] for rec in recs]


def within(value: float, limit: Dict[str, float]) -> bool:
    """Whether a number keeps its limit, {"max": x} or {"min": x}; a
    missing (NaN) number does not."""
    return value <= limit["max"] if "max" in limit else value >= limit["min"]


def compare(per_set: List[Dict[str, float]], limits: Dict[str, Dict[str, float]]):
    """(sets failed, {number: (worst value over the sets, its limit)}); a
    set that lacks a number fails it."""
    nan = float("nan")
    failed = sum(any(not within(s.get(k, nan), lim) for k, lim in limits.items()) for s in per_set)
    checks = {}
    for k, lim in limits.items():
        values = [s.get(k, nan) for s in per_set]
        bad = [v for v in values if not within(v, lim)]
        checks[k] = (bad[0] if bad and math.isnan(bad[0]) else (min if "min" in lim else max)(values), lim)
    return failed, checks
