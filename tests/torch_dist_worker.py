"""One rank of the port's multi-process tests (tests/test_torch_distributed.py).

    python tests/torch_dist_worker.py CASE INIT_URL WORLD RANK OUT_PREFIX

Joins a gloo job on the CPU through sfm_danpipeline_torch.parallel.
distributed.initialize, runs CASE and writes what the parent test compares
to OUT_PREFIX.rank<RANK>.npz. Imports torch and the port only, never JAX.

Cases:
  ba   run_ba_multihost on the two-rank split of the synthetic problem of
       tests/test_multihost.py's worker;
  sfm  compute_features_multihost and compute_matches_multihost on the
       DIST_SCENE courtyard, then run_sfm_multihost with
       ba.sharded_min_obs = 16 (the polish runs), then polish_multihost of
       that result at the default sharded_min_obs (the early return).
"""
import dataclasses
import json
import sys

import numpy as np
import torch

DIST_SCENE = dict(n_views=4, height=240, width=320, ring_fraction=0.08, seed=0)
DIST_MAX_KEYPOINTS = 1024


def ba_problem_numpy():
    """The problem of tests/test_multihost.py's worker: 4 cameras, 96
    points, 0.3 px observation noise, points shaken by 0.02; camera 0 fixed."""
    rng = np.random.default_rng(42)
    n_cam, n_pts = 4, 96
    pts = rng.uniform(-1, 1, (n_pts, 3))
    pts[:, 2] += 4.0
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(0, 0.3, n_cam)
    obs_cam = np.repeat(np.arange(n_cam), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cam).astype(np.int32)
    f = 120.0
    proj = []
    for c in range(n_cam):
        cp = pts + cams[c, 3:]
        proj.append(f * cp[:, :2] / cp[:, 2:3])
    obs_xy = np.concatenate(proj) + rng.normal(0, 0.3, (n_cam * n_pts, 2))
    fix = np.zeros(n_cam, bool)
    fix[0] = True
    noisy_pts = pts + rng.normal(0, 0.02, pts.shape)
    return dict(
        cameras=cams, focal=np.float32(f), points=noisy_pts.astype(np.float32),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_xy=obs_xy.astype(np.float32),
        obs_w=np.ones(n_cam * n_pts, np.float32), fix_cam=fix, fix_focal=np.bool_(False),
    )


def torch_problem(fields, lo=None, hi=None):
    from sfm_danpipeline_torch.ba.problem import BAProblem

    obs = ("obs_cam", "obs_pt", "obs_xy", "obs_w")
    return BAProblem(**{
        k: torch.as_tensor(v[lo:hi] if k in obs else v) for k, v in fields.items()
    })


def dist_config(**ba):
    from sfm_danpipeline_torch.config import FeatureConfig, PipelineConfig

    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=DIST_MAX_KEYPOINTS))
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, **ba))


def case_ba(out):
    import torch.distributed as dist

    from sfm_danpipeline_torch.config import BAConfig
    from sfm_danpipeline_torch.parallel import distributed as D

    fields = ba_problem_numpy()
    O = len(fields["obs_cam"])
    half = O // dist.get_world_size()
    r = dist.get_rank()
    res = D.run_ba_multihost(torch_problem(fields, r * half, (r + 1) * half), BAConfig(max_iterations=40))
    out.update(
        cameras=res.cameras.numpy(), points=res.points.numpy(),
        initial_cost=float(res.initial_cost), final_cost=float(res.final_cost),
        iterations=res.iterations, host_shard=np.asarray(D.host_shard(7)),
    )


def case_sfm(out):
    from sfm_danpipeline_torch.parallel import distributed as D
    from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(**DIST_SCENE)
    cfg = dist_config(sharded_min_obs=16)
    kp = D.compute_features_multihost(scene.images, cfg, torch.device("cpu"))
    m = D.compute_matches_multihost(kp, scene.images.n_images, cfg)
    for f in ("xy", "descriptors", "valid"):
        out[f"kp_{f}"] = getattr(kp, f).numpy()
    for f in ("idx_a", "idx_b", "valid", "dist", "lowe"):
        out[f"m_{f}"] = getattr(m, f).numpy()
    res = D.run_sfm_multihost(
        scene.images, scene.intrinsics, cfg, run_ba_every_view=False, polish_iterations=6,
        device="cpu",
    )
    out.update(
        cameras=res.state.cameras.numpy(), points=res.points,
        registered=np.asarray(res.registered_views), metrics=json.dumps(res.metrics),
    )
    skipped = D.polish_multihost(res, scene.intrinsics, dist_config(), polish_iterations=6)
    out["metrics_default_routing"] = json.dumps(skipped.metrics)


def main():
    case, init, world, rank, prefix = sys.argv[1:6]
    torch.set_num_threads(1)
    from sfm_danpipeline_torch.parallel import distributed as D

    D.initialize(init, int(world), int(rank), device="cpu")
    out = {"backend": D.backend()}
    try:
        {"ba": case_ba, "sfm": case_sfm}[case](out)
    finally:
        D.shutdown()
    np.savez(f"{prefix}.rank{rank}.npz", **out)
    assert "jax" not in sys.modules, "a rank imported jax"
    print(f"rank {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
