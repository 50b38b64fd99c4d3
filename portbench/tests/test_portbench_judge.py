"""The check's comparison on an exact reconstruction of a small scene, and on
corrupted copies of it: the true one passes every limit of every cell, each
corruption fails the number that covers it."""
import dataclasses
import json
import os

import numpy as np
import pytest

from portbench.reference import judge as J
from portbench.reference.scene import render, surface_distance

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("temple6-sift.sparse",)


def _log_so3(R):
    theta = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (0.5 if theta < 1e-12 else theta / (2.0 * np.sin(theta)))


@pytest.fixture(scope="module")
def truth():
    """An exact reconstruction of a 5-view scene, in another gauge (scaled
    by 0.3, turned and shifted), with exact matches between every pair."""
    scene = render(n_views=5, ring_fraction=0.1, seed=2**40 + 7, height=120, width=160)
    rng = np.random.default_rng(0)
    xy0 = rng.uniform([10, 10], [150, 110], (1200, 2))
    X = scene.world_points(0, xy0)
    V = scene.n_views
    # Keypoints: point n is feature n in every view, at its exact projection.
    cam = np.einsum("vij,nj->vni", scene.R, X) + scene.t[:, None]
    kp_xy = cam[..., :2] / cam[..., 2:] * scene.K[0, 0] + scene.K[[0, 1], [2, 2]]
    # Gauge: X_g = g_s * g_R X + g_t; a camera R, t becomes R g_R^T, g_s t - R g_R^T g_t.
    g_s, g_t = 0.3, np.array([1.0, -2.0, 0.5])
    g_R = J.project_so3(rng.normal(size=(3, 3)))
    cameras = np.zeros((V, 6))
    for v in range(V):
        R = scene.R[v] @ g_R.T
        cameras[v, :3] = _log_so3(R)
        cameras[v, 3:] = g_s * scene.t[v] - R @ g_t
    rec = J.Reconstruction(
        cameras=cameras.astype(np.float32), camera_valid=np.ones(V, bool), focal=float(scene.K[0, 0]),
        points=(g_s * X @ g_R.T + g_t).astype(np.float32),
        tracks=np.tile(np.arange(len(X), dtype=np.int32)[:, None], (1, V)),
        kp_xy=kp_xy.astype(np.float32),
        match_pairs=np.stack(np.triu_indices(V, 1), -1),
        match_a=np.tile(np.arange(len(X), dtype=np.int32), (V * (V - 1) // 2, 1)),
        match_b=np.tile(np.arange(len(X), dtype=np.int32), (V * (V - 1) // 2, 1)),
        match_valid=np.ones((V * (V - 1) // 2, len(X)), bool),
    )
    return scene, rec


def _limits(cell):
    with open(os.path.join(ROOT, "portbench", "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def _copy(rec, **kw):
    fields = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}
    fields.update(kw)
    return J.Reconstruction(**{k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in fields.items()})


def test_surface_distance():
    X = np.array([[0.0, 0.0, 9.0], [11.0, 0.0, 0.0], [0.0, 6.0, 0.0]])
    assert np.allclose(surface_distance(X), [1.0, 1.0, 0.0])


@pytest.mark.parametrize("cell", CELLS)
def test_true_reconstruction_passes(truth, cell):
    scene, rec = truth
    numbers = J.judge(rec, scene)
    assert numbers["views_missing"] == 0
    for name, limit in _limits(cell).items():
        assert J.within(numbers[name], limit), (name, numbers[name], limit)
    assert numbers["ate_pct"] < 1e-3 and numbers["rot_err_deg"] < 1e-3
    assert numbers["reproj_rms_px"] < 1e-2 and numbers["track_outlier_pct"] == 0.0
    assert numbers["match_outlier_pct"] == 0.0


def _corruptions(rec):
    cams = rec.cameras.copy()
    cams[3, 3:] += 0.05  # one camera moved
    turned = rec.cameras.copy()
    turned[2, :3] += np.float32(0.03)  # one camera turned by ~1.7 degrees
    tracks = rec.tracks.copy()
    tracks[:240, 2] = np.roll(tracks[:240, 2], 1)  # 240 wrong matches in view 2
    match_b = rec.match_b.copy()
    match_b[:, :300] = np.roll(match_b[:, :300], 1, axis=1)  # 300 wrong matches in every pair
    missing = rec.camera_valid.copy()
    missing[4] = False
    return {
        "camera_moved": (_copy(rec, cameras=cams), ("ate_pct", "reproj_rms_px")),
        "camera_turned": (_copy(rec, cameras=turned), ("rot_err_deg", "reproj_rms_px")),
        "wrong_matches": (_copy(rec, tracks=tracks), ("track_outlier_pct", "reproj_rms_px")),
        "view_missing": (_copy(rec, camera_valid=missing), ("views_missing",)),
        "points_off": (_copy(rec, points=rec.points * np.float32(1.05)), ("point_p95_pct", "reproj_rms_px")),
        "wrong_raw_matches": (_copy(rec, match_b=match_b), ("match_outlier_pct",)),
    }


@pytest.mark.parametrize(
    "fault", ["camera_moved", "camera_turned", "wrong_matches", "view_missing", "points_off", "wrong_raw_matches"]
)
def test_corruption_fails(truth, fault):
    scene, rec = truth
    bad, names = _corruptions(rec)[fault]
    numbers = J.judge(bad, scene)
    assert all(numbers[name] > J.judge(rec, scene)[name] for name in names), (fault, numbers)
    limits = _limits("temple6-sift.sparse")
    for name in names:
        if name in limits:
            assert not J.within(numbers[name], limits[name]), (fault, name, numbers[name], limits[name])
    assert J.compare([numbers], limits)[0] == 1, (fault, numbers)


def test_equal_outputs_are_judged_once(truth, monkeypatch):
    scene, rec = truth
    calls = []
    real = J.judge
    monkeypatch.setattr(J, "judge", lambda r, s: calls.append(1) or real(r, s))
    out = J.judge_each([rec, _copy(rec), _copy(rec, points=rec.points * np.float32(1.05))], scene)
    assert len(calls) == 2 and out[0] == out[1] and out[2] != out[0]
