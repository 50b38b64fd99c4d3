#!/usr/bin/env python3
"""Where the port's run parts from the JAX reference's for one RANSAC seed,
on a CPU (both packages imported; run with `JAX_PLATFORMS=cpu`).

    python3 tools/seed_parity.py injected flow|guided --seeds 0 1 2 ... [--float64-fits]

runs the port's SfMPipeline on the CPU on the reference's own front end:
its SIFT keypoints, and for `flow` its LK-flow match tables (slot order
included), at each `geometry.seed`, and prints each run's outcome. The
scenes are the narrow flow arc (V=10, ring_fraction 0.05, method flow) and
the guided V=20 arc (ring_fraction 0.4, geometry.guided_enable). Compare
with `tools/reference_flow_seeds.py` and `tools/guided_arc.py --seed`: what
still parts on identical inputs and draws parts in the back end.

With --float64-fits both packages evaluate their own null-vector fits (the
8-point essential, the 4-point homography and its refit, the PnP DLT) in
float64 and round the model to float32, and the reference's run on the same
front end is printed beside the port's. In float32 the two packages form
A^T A in other summation orders, and on near-degenerate samples its null
vector follows that rounding; this run shows what parts once it is gone.

    python3 tools/seed_parity.py pair-basins A B [--views 20] [--ring-fraction 0.4] [--seed 0]

runs both packages' `estimate_relative_pose_basins` on pair (A, B) of the
courtyard arc, on the reference's keypoints and strict matches, with the
essential key pair scoring gives that pair at `--seed`, and prints each
basin candidate's inlier counts and the rotation gap between the packages.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _reference_keypoints(scene, config):
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.ops.sift import detect_and_compute_batch

    return detect_and_compute_batch(jnp.asarray(scene.images.gray), config.features)


def _float64_fits():
    """Evaluate both packages' null-vector fits in float64, each with its
    own code (the reference's through a host callback under
    jax.enable_x64), the model rounded to float32."""
    import jax
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.ops import epipolar as j_epi
    from sfm_danpipeline_tpu.ops import homography as j_hom
    from sfm_danpipeline_tpu.ops import pnp as j_pnp
    from sfm_danpipeline_torch.ops import epipolar as t_epi
    from sfm_danpipeline_torch.ops import homography as t_hom
    from sfm_danpipeline_torch.ops import pnp as t_pnp

    def reference_f64(fn):
        batched = {}

        def wrapped(*args):
            out = jax.eval_shape(fn, *args)
            nds = [a.ndim for a in args]

            def host(*arrs):
                lead = arrs[0].shape[: arrs[0].ndim - nds[0]]
                flat = [
                    np.asarray(a, np.float64).reshape((-1,) + a.shape[a.ndim - n:])
                    for a, n in zip(arrs, nds)
                ]
                with jax.enable_x64(True):
                    f = batched.setdefault("f", jax.jit(jax.vmap(fn)))
                    r = f(*(jnp.asarray(a) for a in flat))
                return np.asarray(r, np.float32).reshape(lead + out.shape)

            return jax.pure_callback(
                host, jax.ShapeDtypeStruct(out.shape, jnp.float32), *args, vmap_method="broadcast_all"
            )

        return wrapped

    def port_f64(fn):
        return lambda *a: fn(*(t.double() for t in a)).float()

    fits = ("_fit_essential_dlt", "_homography_from_four", "_homography_refit", "_dlt_pnp")
    for ref_mod, port_mod in ((j_epi, t_epi), (j_hom, t_hom), (j_pnp, t_pnp)):
        for name in fits:
            if hasattr(ref_mod, name):
                setattr(ref_mod, name, reference_f64(getattr(ref_mod, name)))
                setattr(port_mod, name, port_f64(getattr(port_mod, name)))


def _outcome(res, scene, cameras):
    from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers

    m = res.metrics
    regs = sorted(res.registered_views)
    gt = scene.centers[regs]
    ate = 100 * aligned_rmse(camera_centers(cameras)[regs], gt) / float(np.linalg.norm(gt.max(0) - gt.min(0)))
    return "%d/%d, seed pair (%d, %d), RMS %.4f px, %d points, ATE %.3f%%, %d guided" % (
        len(regs), scene.images.n_images, m["baseline_pair_i"], m["baseline_pair_j"],
        m["ba_rms_px"], m["n_points"], ate, m.get("n_guided_registered", 0),
    )


def injected(mode, seeds, float64_fits=False):
    import jax
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.config import PipelineConfig as JConfig
    from sfm_danpipeline_tpu.ops import flow as j_flow
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
    from sfm_danpipeline_torch import interop
    from sfm_danpipeline_torch.config import PipelineConfig
    from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline, _pair_list

    if float64_fits:
        _float64_fits()
    flow = mode == "flow"
    scene = make_courtyard_scene(n_views=10 if flow else 20, ring_fraction=0.05 if flow else 0.4, seed=0)
    jcfg = JConfig()
    kp = _reference_keypoints(scene, jcfg)
    fields = ("xy", "sigma", "angle", "response", "descriptors", "valid")
    tkp = interop.keypoints_from_numpy({k: np.asarray(getattr(kp, k)) for k in fields})
    matches = None
    if flow:
        g = jnp.asarray(scene.images.gray)
        pi, pj = _pair_list(scene.images.n_images)
        per_pair = [
            j_flow.flow_match_pair(
                g[a], g[b], kp.xy[a], kp.valid[a], kp.xy[b], kp.valid[b],
                radius=jcfg.matching.flow_radius, max_matches=jcfg.matching.max_matches,
            )
            for a, b in zip(pi, pj)
        ]
        m = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *per_pair)
        matches = interop.matches_from_numpy(
            {k: np.asarray(getattr(m, k)) for k in ("idx_a", "idx_b", "dist", "lowe", "valid")}
        )
    base = PipelineConfig()
    for seed in seeds:
        cfg = dataclasses.replace(
            base,
            geometry=dataclasses.replace(base.geometry, seed=seed, guided_enable=not flow),
            matching=dataclasses.replace(base.matching, method="flow" if flow else "bf"),
        )
        try:
            res = SfMPipeline(cfg, device="cpu").run(
                scene.images, scene.intrinsics, precomputed_keypoints=tkp, precomputed_matches=matches
            )
            port = _outcome(res, scene, res.state.cameras.numpy())
        except RuntimeError as e:
            port = str(e)
        print(f"{mode} seed {seed} on the reference's front end: {port}", flush=True)
        if float64_fits:
            from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline as JPipeline

            jc = dataclasses.replace(
                jcfg,
                geometry=dataclasses.replace(jcfg.geometry, seed=seed, guided_enable=not flow),
                matching=dataclasses.replace(jcfg.matching, method="flow" if flow else "bf"),
            )
            try:
                res = JPipeline(jc).run(scene.images, scene.intrinsics)
                ref = _outcome(res, scene, np.asarray(res.state.cameras, np.float32))
            except RuntimeError as e:
                ref = str(e)
            print(f"{mode} seed {seed}, the reference with float64 fits: {ref}", flush=True)
    return 0


def pair_basins(a, b, n_views, ring_fraction, seed):
    import jax
    import jax.numpy as jnp
    import torch

    from sfm_danpipeline_tpu.config import PipelineConfig as JConfig
    from sfm_danpipeline_tpu.ops import epipolar as j_epi
    from sfm_danpipeline_tpu.ops.matching import match_all_pairs
    from sfm_danpipeline_tpu.ops.projection import undistort_points
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
    from sfm_danpipeline_torch import interop
    from sfm_danpipeline_torch.ops import epipolar as t_epi

    scene = make_courtyard_scene(n_views=n_views, ring_fraction=ring_fraction, seed=0)
    cfg = JConfig()
    kp = _reference_keypoints(scene, cfg)
    m = match_all_pairs(
        kp.descriptors, kp.valid, jnp.asarray([a]), jnp.asarray([b]),
        ratio=max(cfg.matching.ratio, cfg.matching.registration_ratio),
        max_matches=cfg.matching.max_matches, strict_ratio=cfg.matching.ratio, xy=kp.xy,
        dup_radius=cfg.matching.dup_radius, dedup=cfg.matching.dedup_matches,
    ).at_ratio(cfg.matching.ratio)
    pi, pj = np.triu_indices(n_views, 1)
    p = int(np.nonzero((pi == a) & (pj == b))[0][0])
    # Pair scoring's keys: the root's first half, split per pair, then the
    # essential half of the pair's.
    k_score = jax.random.split(jax.random.key(seed), 2)[0]
    k_e = jax.random.split(jax.random.split(k_score, len(pi))[p])[0]
    K = jnp.asarray(scene.intrinsics.K, jnp.float32)
    dist = jnp.zeros(5, jnp.float32)
    x1 = undistort_points(kp.xy[a][m.idx_a[0]], K, dist)
    x2 = undistort_points(kp.xy[b][m.idx_b[0]], K, dist)
    v = m.valid[0]
    f = float(K[0, 0])
    rj = j_epi.estimate_relative_pose_basins(k_e, x1, x2, v, focal=f)
    rt = t_epi.estimate_relative_pose_basins(
        interop.key_from_numpy(jax.random.key_data(k_e)), torch.tensor(np.asarray(x1)),
        torch.tensor(np.asarray(x2)), torch.tensor(np.asarray(v)), focal=f,
    )

    def angle(A, B):
        return float(np.degrees(np.arccos(np.clip((np.trace(A @ B.T) - 1) / 2, -1, 1))))

    print(f"pair ({a}, {b}) of the V={n_views} arc, pair index {p}, {int(v.sum())} strict matches, seed {seed}")
    for c in range(2):
        print(
            "candidate %d: reference %d inliers (ok %s), port %d inliers (ok %s), rotations %.4f "
            "degrees apart"
            % (
                c, int(rj.n_inliers[c]), bool(rj.ok[c]), int(rt.n_inliers[c]), bool(rt.ok[c]),
                angle(np.asarray(rj.R[c]), rt.R[c].numpy()),
            )
        )
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    inj = sub.add_parser("injected")
    inj.add_argument("mode", choices=["flow", "guided"])
    inj.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    inj.add_argument("--float64-fits", action="store_true")
    pb = sub.add_parser("pair-basins")
    pb.add_argument("a", type=int)
    pb.add_argument("b", type=int)
    pb.add_argument("--views", type=int, default=20)
    pb.add_argument("--ring-fraction", type=float, default=0.4)
    pb.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.cmd == "injected":
        return injected(args.mode, args.seeds, args.float64_fits)
    return pair_basins(args.a, args.b, args.views, args.ring_fraction, args.seed)


if __name__ == "__main__":
    sys.exit(main())
