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

    python3 tools/seed_parity.py bench --seeds S ... [--workload arc20-sift.sparse]
        [--package reference port injected] [--trail-dir DIR]

renders one benchmark cell's scene (portbench/reference/scene.py, on the
CPU) at each texture seed and runs each package's SfMPipeline on it on the
CPU with the configuration's PipelineConfig and its default key (`injected`:
the port on the reference's keypoints and matches). Per run it prints the
outcome (views, components, merges with their gates, `rotavg_applied`, RMS,
points, ATE) and writes the decision trail to
`<workload>_seed<S>_<package>.log` under `--trail-dir`.

    python3 tools/seed_parity.py ring --seeds 0 1 2 [--package reference|port|both]
        [--trail-dir DIR] [--device cpu|cuda] [--front-end F.npz]

runs the reference's SfMPipeline and the port's on the closed ring
`make_courtyard_scene(n_views=50, ring_fraction=1.0, seed=0)` (480x640,
1,225 pairs) with the default config at each `geometry.seed`. Each package
computes its front end once and feeds it to every seed's run (the stages
are deterministic, so this is the run without injection). Per run it
prints the registered views, the seed pair, each secondary component's
seed pair, views and merge gates (`n_cross_tracks`, `merge_cross_med_px`),
`rotavg_applied`, the registration keys taken, RMS, points and ATE.
`--trail-dir` writes each run's decision trail (every log line of the
pipeline but its timings: seeds, each view's PnP inliers, merges, the final
BA, the reinit's compared costs) to `ring50_seed<S>_<package>.log`, so
that `diff` shows the first place two runs part. The port runs on
`--device` (the card with `--package port --device cuda`, which needs no
JAX). `injected ring --seeds ...` runs the port on the reference's
keypoints and matches (with `--front-end F.npz` it also saves them there;
`ring --package port --front-end F.npz` runs the port on a saved front end,
on the card too).

    python3 tools/seed_parity.py ring-step VIEW --seed S [--prev V0]

runs the reference's pipeline on the ring up to the registration of VIEW,
feeds its inputs to that registration (state, key, tables) to the port's
PnP registration and prints both counts; with `--prev`, also runs the
port's whole step (PnP, triangulation, BA) of the view registered just
before, on the reference's inputs to it, and prints how far it ends from
the reference's next state (beside how far the reference's own step ends
from it evaluated op by op, another rounding of the same arithmetic) and
what VIEW's registration counts on it.

    python3 tools/seed_parity.py merge-step --seed S [--eager] [--ulps N]

runs the reference's pipeline on the ring at geometry seed S and feeds
each of its Sim(3) merge attempts' inputs (both components' states, the
key, the tables) to the port's `merge_attempt_step`: it prints both
packages' Sim(3) inliers, scale, gate values and decision side by side,
and how far the merged states end apart; `--eager` adds the reference's
own attempt evaluated op by op (`jax.disable_jit`), the spread rounding
alone gives; `--ulps N` runs each accepted attempt's intermediate BA in
both packages on the reference's own pre-BA state and on it with every
point scaled by 1 + k * 1e-7 (|k| <= N), printing final costs and gate 2.
"""
import argparse
import contextlib
import dataclasses
import logging
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ring_capture  # noqa: E402  (tools/, the script's own directory)


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


RING_VIEWS = 50


class _Trail(logging.Handler):
    """One package's pipeline log, each line as printed, without the lines
    that carry wall times."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        if "%.2fs" not in str(record.msg):
            self.lines.append(record.getMessage())


@contextlib.contextmanager
def _instrument(pipe_cls, sfm_mod, merge_name, merge_stats):
    """Record every `_try_seed` outcome and every merge attempt's gates of
    one package's pipeline while the block runs; yields (seeds, merges),
    filled as it runs, and puts both functions back after it."""
    seeds, merges = [], []
    try_seed = pipe_cls._try_seed
    merge = getattr(sfm_mod, merge_name)

    def recorded_try_seed(self, *a, **k):
        out = try_seed(self, *a, **k)
        seeds.append(None if out is None else tuple(int(v) for v in out[2]))
        return out

    def recorded_merge(*a, **k):
        state, stats = merge(*a, **k)
        merges.append(merge_stats(a, stats))
        return state, stats

    pipe_cls._try_seed = recorded_try_seed
    setattr(sfm_mod, merge_name, recorded_merge)
    try:
        yield seeds, merges
    finally:
        pipe_cls._try_seed = try_seed
        setattr(sfm_mod, merge_name, merge)


def _seed_config(config_module, seed):
    c = config_module.PipelineConfig()
    return dataclasses.replace(c, geometry=dataclasses.replace(c.geometry, seed=seed))


def _reference_front_end(scene, cfg):
    """The reference's SIFT keypoints and loose-ratio matches over every
    pair, as its SfMPipeline.run computes them on a CPU."""
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.ops.matching import match_all_pairs
    from sfm_danpipeline_tpu.pipeline.sfm import _pair_list

    kp = _reference_keypoints(scene, cfg)
    pi, pj = _pair_list(scene.images.n_images)
    m = cfg.matching
    matches = match_all_pairs(
        kp.descriptors, kp.valid, jnp.asarray(pi), jnp.asarray(pj),
        ratio=max(m.ratio, m.registration_ratio), max_matches=m.max_matches, use_pallas=False,
        strict_ratio=m.ratio, xy=kp.xy, dup_radius=m.dup_radius, dedup=m.dedup_matches,
    )
    return kp, matches


def _reference_front_end_numpy():
    """The reference's front end on the ring as numpy dicts (keypoints,
    matches)."""
    from sfm_danpipeline_tpu import config
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene

    scene = make_courtyard_scene(n_views=RING_VIEWS, ring_fraction=1.0, seed=0)
    kp, matches = _reference_front_end(scene, config.PipelineConfig())
    fields = ("xy", "sigma", "angle", "response", "descriptors", "valid")
    return (
        {k: np.asarray(getattr(kp, k)) for k in fields},
        {k: np.asarray(getattr(matches, k)) for k in ("idx_a", "idx_b", "dist", "lowe", "valid")},
    )


def _reference_ring(scene, seeds):
    """The reference's SfMPipeline at each seed, on its own front end
    computed once. Yields (seed, result or RuntimeError, pipeline)."""
    from sfm_danpipeline_tpu import config
    from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline

    kp, matches = _reference_front_end(scene, config.PipelineConfig())
    for seed in seeds:
        pipe = SfMPipeline(_seed_config(config, seed))
        try:
            res = pipe.run(scene.images, scene.intrinsics, precomputed_keypoints=kp, precomputed_matches=matches)
        except RuntimeError as e:
            res = e
        yield seed, res, pipe


def _port_ring(scene, seeds, device, front_end=None):
    """The port's SfMPipeline on `device` at each seed, on its own front end
    computed once, or on `front_end` (the reference's keypoints and matches
    as numpy dicts)."""
    import torch

    from sfm_danpipeline_torch import config, interop
    from sfm_danpipeline_torch.ops.matching import match_all_pairs
    from sfm_danpipeline_torch.ops.sift import detect_and_compute_batch
    from sfm_danpipeline_torch.pipeline import sfm as t_sfm

    cfg = config.PipelineConfig()
    if front_end is not None:
        kp = interop.keypoints_from_numpy(front_end[0], device)
        matches = interop.matches_from_numpy(front_end[1], device)
    else:
        kp = detect_and_compute_batch(torch.as_tensor(scene.images.gray, device=device), cfg.features)
        pi, pj = (torch.tensor(a, dtype=torch.int32, device=device) for a in t_sfm._pair_list(RING_VIEWS))
        m = cfg.matching
        matches = match_all_pairs(
            kp.descriptors, kp.valid, pi, pj, ratio=max(m.ratio, m.registration_ratio),
            max_matches=m.max_matches, strict_ratio=m.ratio, xy=kp.xy,
            dup_radius=m.dup_radius, dedup=m.dedup_matches,
        )
    for seed in seeds:
        pipe = t_sfm.SfMPipeline(_seed_config(config, seed), device=device)
        try:
            res = pipe.run(scene.images, scene.intrinsics, precomputed_keypoints=kp, precomputed_matches=matches)
        except RuntimeError as e:
            res = e
        yield seed, res, pipe


def _load_front_end(path):
    z = np.load(path)
    return (
        {k[3:]: z[k] for k in z.files if k.startswith("kp_")},
        {k[2:]: z[k] for k in z.files if k.startswith("m_")},
    )


def _print_ring_run(tag, res, pipe, scene, seed_log, merges):
    from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers

    m = res.metrics
    regs = sorted(res.registered_views)
    cams = res.state.cameras
    cams = cams.cpu().numpy() if hasattr(cams, "cpu") else np.asarray(cams, np.float32)
    gt = scene.centers[regs]
    ate = 100 * aligned_rmse(camera_centers(cams)[regs], gt) / float(np.linalg.norm(gt.max(0) - gt.min(0)))
    comp_seeds = [s for s in seed_log if s is not None][1:]
    print(f"{tag}: {len(regs)}/{RING_VIEWS} registered {regs}", flush=True)
    print(
        f"{tag}: seed pair ({m['baseline_pair_i']}, {m['baseline_pair_j']}), "
        f"{len(comp_seeds)} secondary component(s), rotavg_applied {m.get('rotavg_applied')}, "
        f"{ring_capture.keys_taken(pipe)} registration keys",
        flush=True,
    )
    for n, (views, ms) in enumerate(merges):
        cs = comp_seeds[n] if n < len(comp_seeds) else None
        print(f"{tag}: component {n + 2} seed {cs} views {views}: {_merge_line(ms)}", flush=True)
    print("%s: RMS %.4f px, %d points, ATE %.4f%%" % (tag, m["ba_rms_px"], m["n_points"], ate), flush=True)


def _merge_line(ms):
    return (
        f"merged {int(ms['accepted'])}, Sim3 ok {int(ms['sim_ok'])} ({ms['n_sim_inliers']} inliers, "
        f"scale {ms['scale']:.4f}), gate1 {ms['med_gate1_px']:.4f} px, n_cross_tracks "
        f"{ms['n_cross_tracks']}, merge_cross_med_px {ms['med_gate2_px']:.4f}"
    )


def ring(seeds, packages, trail_dir, injected=False, device="cpu", front_end_file=None):
    """Both packages on the closed ring at each geometry seed (module
    docstring)."""
    for package in packages:
        if package == "reference":
            from sfm_danpipeline_tpu.pipeline import sfm as sfm_mod
            from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene

            merge_name = "_merge_attempt_step"

            def merge_stats(a, ms):
                return [int(v) for v in np.nonzero(np.asarray(a[3]))[0]], ring_capture.merge_stats(ms)
        else:
            from sfm_danpipeline_torch.pipeline import sfm as sfm_mod
            from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

            merge_name = "merge_attempt_step"

            def merge_stats(a, ms):
                return list(a[3]), ms

        scene = make_courtyard_scene(n_views=RING_VIEWS, ring_fraction=1.0, seed=0)
        short = package
        if package == "reference":
            runs = _reference_ring(scene, seeds)
        elif injected or front_end_file:
            if injected:
                front = _reference_front_end_numpy()
                if front_end_file:
                    np.savez(front_end_file, **{f"kp_{k}": v for k, v in front[0].items()},
                             **{f"m_{k}": v for k, v in front[1].items()})
            else:
                front = _load_front_end(front_end_file)
            runs = _port_ring(scene, seeds, device, front)
            package, short = "port on the reference's front end", "port_injected"
        else:
            runs = _port_ring(scene, seeds, device)
        if short != "reference" and device != "cpu":
            short += "_" + device
        trail = _Trail()
        logger = logging.getLogger("sfm_danpipeline_tpu" if package == "reference" else "sfm_danpipeline_torch")
        logger.addHandler(trail)
        logger.setLevel(logging.INFO)
        t0 = time.time()
        try:
            with _instrument(sfm_mod.SfMPipeline, sfm_mod, merge_name, merge_stats) as (seed_log, merges):
                for seed, res, pipe in runs:
                    tag = f"ring V={RING_VIEWS} seed {seed}, {package}"
                    if isinstance(res, RuntimeError):
                        print(f"{tag}: {res}", flush=True)
                    else:
                        _print_ring_run(tag, res, pipe, scene, seed_log, merges)
                        print(f"{tag}: {time.time() - t0:.1f} s", flush=True)
                        if trail_dir:
                            os.makedirs(trail_dir, exist_ok=True)
                            name = f"ring{RING_VIEWS}_seed{seed}_{short}.log"
                            with open(os.path.join(trail_dir, name), "w") as f:
                                f.write("\n".join(trail.lines) + "\n")
                    trail.lines.clear()
                    seed_log.clear()
                    merges.clear()
                    t0 = time.time()
        finally:
            logger.removeHandler(trail)
    return 0


def _reference_ring_run(seed):
    """The reference's pipeline at `seed` on the ring, as a callable for
    ring_capture.capture, and the port's config at that seed."""
    from sfm_danpipeline_tpu import config as j_config
    from sfm_danpipeline_tpu.pipeline import sfm as j_sfm
    from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene
    from sfm_danpipeline_torch import config

    scene = make_courtyard_scene(n_views=RING_VIEWS, ring_fraction=1.0, seed=0)
    jc = _seed_config(j_config, seed)
    kp, matches = _reference_front_end(scene, jc)

    def run():
        j_sfm.SfMPipeline(jc).run(
            scene.images, scene.intrinsics, precomputed_keypoints=kp, precomputed_matches=matches
        )

    return run, _seed_config(config, seed)


def ring_step(seed, view, prev=None):
    """Both packages' registration of `view` on the reference's own inputs;
    with `prev`, also the port's whole step (register, triangulate, BA) of
    the view registered just before it, on the reference's inputs to that
    step (module docstring)."""
    import jax
    import torch

    from sfm_danpipeline_tpu.pipeline import sfm as j_sfm
    from sfm_danpipeline_torch.pipeline.incremental import register_view
    from sfm_danpipeline_torch.pipeline.sfm import register_adjust_step

    run, cfg = _reference_ring_run(seed)
    wanted = {view: "view"} if prev is None else {view: "view", prev: "prev"}
    step, captured, err = ring_capture.capture(
        j_sfm, "_register_adjust_step", run, lambda n, a: wanted.get(int(a[2])), len(wanted)
    )
    if err is not None:
        print(f"seed {seed}: {err}")
    if len(captured) < len(wanted):
        print(f"seed {seed}: view {view} or view {prev} was not reached")
        return 1

    def port_register(p, state):
        c = p["inputs"]
        _, ok, n_inl, n_sup = register_view(
            p["key"], state, view, p["done_views"], c.tables.feat_a, c.tables.feat_b, c.tables.loose,
            c.kp.xy, c.K, c.dist, c.max_dim, cfg, valid_tab_strict=c.tables.strict,
        )
        return int(ok), int(n_inl), int(n_sup)

    a = captured["view"]
    p = ring_capture.step_args(a, cfg)
    ref = [int(x) for x in np.asarray(step(*a)[1])]
    ok, n_inl, n_sup = port_register(p, p["state"])
    tag = f"ring V={RING_VIEWS} seed {seed}, view {view}"
    print(
        f"{tag} on the reference's state and key, {len(p['done_views'])} done views: reference ok "
        f"{ref[0]}, {ref[1]} PnP inliers of {ref[2]} support; port ok {ok}, {n_inl} of {n_sup}",
        flush=True,
    )
    if prev is None:
        return 0
    out, _ = register_adjust_step(**ring_capture.step_args(captured["prev"], cfg))
    with jax.disable_jit():
        eager = step(*captured["prev"])[0]
    want = p["state"]
    cams = want.camera_valid
    pts = want.points_valid & out.points_valid

    def gap(a, b, mask):
        return float((torch.as_tensor(np.asarray(a))[mask] - b[mask]).abs().max())

    print(
        "%s: the port's step of view %d on the reference's inputs to it ends %.3e from the "
        "reference's cameras (largest |difference|, %d cameras) and %.3e from its points (%d "
        "points, the reference %d, the port %d); the reference's step evaluated op by op "
        "(jax.disable_jit) ends %.3e and %.3e from them"
        % (
            tag, prev, gap(out.cameras, want.cameras, cams), int(cams.sum()),
            gap(out.points_xyz, want.points_xyz, pts), int(pts.sum()),
            int(want.points_valid.sum()), int(out.points_valid.sum()),
            gap(eager.cameras, want.cameras, cams), gap(eager.points_xyz, want.points_xyz, pts),
        )
    )
    ok, n_inl, n_sup = port_register(p, out)
    print(f"{tag} on the port's state after that step and the same key: ok {ok}, {n_inl} of {n_sup}")
    return 0


def merge_step(seed, eager=False, ulps=0):
    """Every merge attempt of the reference's run on the ring at `seed`,
    its inputs fed to the port's `merge_attempt_step` (the same key, so the
    same Sim(3) draws): both packages' Sim(3) inliers, gates and decision,
    and how far the port's merged state ends from the reference's; with
    `eager`, also the reference's attempt evaluated op by op
    (jax.disable_jit), another rounding of the same arithmetic; with `ulps`,
    `_merge_ba_ulps` on every attempt the reference accepts."""
    import jax
    import torch

    from sfm_danpipeline_tpu.pipeline import sfm as j_sfm
    from sfm_danpipeline_torch.pipeline import sfm as t_sfm
    from sfm_danpipeline_torch.pipeline.tracks import live_observations

    run, cfg = _reference_ring_run(seed)
    merge, captured, err = ring_capture.capture(j_sfm, "_merge_attempt_step", run, lambda n, a: n, 0)
    if err is not None:
        print(f"seed {seed}: {err}")
    ba_step = t_sfm.ba_step
    ba_input = []

    def recorded_ba_step(state, *a, **k):
        ba_input.append((int(state.n_points), int(torch.sum(live_observations(state)))))
        return ba_step(state, *a, **k)

    for n, a in sorted(captured.items()):
        want, stats = merge(*a)
        ref = ring_capture.merge_stats(stats)
        p = ring_capture.merge_args(a, cfg)
        ba_input.clear()
        t_sfm.ba_step = recorded_ba_step
        try:
            out, got = t_sfm.merge_attempt_step(**p)
        finally:
            t_sfm.ba_step = ba_step
        tag = f"ring V={RING_VIEWS} seed {seed}, merge attempt {n} (component {p['b_views']})"
        print(f"{tag}: reference {_merge_line(ref)}", flush=True)
        print(f"{tag}: port on its inputs {_merge_line(got)}", flush=True)
        if ba_input:
            # The reference's merge BA holds the first n_bucket points and at
            # most n_obs_bucket observations (a[15], a[16]); past them it
            # drops observations without a word (ROADMAP, reference defects).
            print(
                f"{tag}: the port's merge BA takes {ba_input[0][0]} points and {ba_input[0][1]} "
                f"observations; the reference's buckets hold {int(a[15])} and {int(a[16])}",
                flush=True,
            )
        if got["accepted"]:
            turn = torch.linalg.norm(out.cameras[p["b_views"], :3], dim=1) * (180 / np.pi)
            print(f"{tag}: the component's cameras turn by {turn.numpy().round(2).tolist()} degrees "
                  "(angle-axis norm) after the Sim(3)", flush=True)
        if ulps and ref["accepted"]:
            _merge_ba_ulps(tag, a, cfg, ulps)
        others = [("port", out, got)]
        if eager:
            with jax.disable_jit():
                st, ms = merge(*a)
            others.append(("reference op by op", ring_capture.port_state(st), ring_capture.merge_stats(ms)))
            print(f"{tag}: reference op by op {_merge_line(others[-1][2])}", flush=True)
        for name, st, ms in others:
            if ref["accepted"] and ms["accepted"]:
                print(f"{tag}: {name}'s merged state {_state_gap(want, st)}", flush=True)
    return 0


def _merge_ba_ulps(tag, a, cfg, ulps):
    """The intermediate BA of a merge attempt on one input in both packages:
    the reference's pre-BA state, rebuilt with its own functions from the
    attempt's arguments `a` (Sim(3), merge, triangulation of the
    component's views), and that state with every point scaled by
    1 + k * 1e-7 (about one float32 rounding step) for k = -ulps..ulps.
    Prints each run's final cost and gate 2 (the post-BA cross-track
    median): where a rounding step of the input moves them as far as the
    packages part, the parting is rounding."""
    import jax.numpy as jnp
    import torch

    from sfm_danpipeline_tpu.ops.similarity import estimate_sim3_reproj_ransac
    from sfm_danpipeline_tpu.pipeline import merge as j_merge
    from sfm_danpipeline_tpu.pipeline import sfm as j_sfm
    from sfm_danpipeline_tpu.pipeline.incremental import triangulate_new_view_all
    from sfm_danpipeline_torch.pipeline import merge as t_merge
    from sfm_danpipeline_torch.pipeline import sfm as t_sfm

    key, state_a, state_b, b_mask, dv_a, ft_a, ft_b, vt, xy, colors, pp, K, dist, fix, jc = a[:15]
    n_bucket, n_obs_bucket = a[15], a[16]
    bound = jc.geometry.max_merge_reprojection_px
    K_cur = jnp.asarray([[state_a.focal, 0, pp[0]], [0, state_a.focal, pp[1]], [0, 0, 1]], jnp.float32)
    Xa, Xb, pid_a, pid_b, va, fa, m = j_merge.cross_component_pairs(state_a, state_b, ft_a, ft_b, vt)
    sim = estimate_sim3_reproj_ransac(
        key, Xb, Xa, state_a.cameras[va], xy[va, fa], K_cur, m, threshold_px=0.75 * bound,
        n_hypotheses=16384, min_inliers=8,
    )
    pre = j_merge.merge_components(state_a, state_b, sim.sim, pid_a, pid_b, sim.inliers)
    for v in np.nonzero(np.asarray(b_mask))[0]:
        pre, _ = triangulate_new_view_all(pre, jnp.int32(v), dv_a, ft_a, ft_b, vt, xy, colors, K, dist, jc)
    b = torch.as_tensor(np.asarray(b_mask))
    txy, tpp = torch.as_tensor(np.asarray(xy)), torch.as_tensor(np.asarray(pp))

    def gate2(st):
        has = st.track_feat >= 0
        cross = torch.any(has & b[None], 1) & torch.any(has & (~b & st.camera_valid)[None], 1) & st.points_valid
        return t_merge.views_reprojection_median(st, b, txy, t_sfm._k_matrix(st.focal, tpp), points_mask=cross)

    for k in range(-ulps, ulps + 1):
        st = dataclasses.replace(pre, points_xyz=pre.points_xyz * jnp.float32(1.0 + k * 1e-7))
        ref = j_sfm._ba_step(
            st, xy, pp, fix, n_bucket, n_obs_bucket, jc.ba, not jc.ba.optimize_focal,
            float(jc.geometry.max_reprojection_error_px), jnp.asarray(jc.ba.intermediate_iterations, jnp.int32),
        )
        port = t_sfm.ba_step(
            ring_capture.port_state(st), txy, tpp, torch.as_tensor(np.asarray(fix)), cfg,
            cfg.ba.intermediate_iterations,
        )
        print(
            "%s: merge BA on the reference's pre-BA state, points x (1 %+d e-7): reference cost %.6g "
            "-> %.6g, gate 2 %.4f px; port -> %.6g, gate 2 %.4f px"
            % (tag, k, float(ref[1]), float(ref[2]), gate2(ring_capture.port_state(ref[0])),
               float(port[2]), gate2(port[0])),
            flush=True,
        )


def _state_gap(want, st):
    """How far state `st` (the port's types) ends from the reference's
    `want`: the largest camera and point differences and the cameras that
    differ most."""
    import torch

    want = ring_capture.port_state(want)
    cams = want.camera_valid & st.camera_valid
    pts = want.points_valid & st.points_valid
    per_cam = (want.cameras - st.cameras).abs().amax(dim=1).where(cams, torch.zeros(()))
    worst = [int(v) for v in per_cam.argsort(descending=True)[:3]]
    return "%.3e from the reference's cameras (%d; most at views %s: %s), %.3e from its points " \
        "(%d of the reference's %d, its own %d)" % (
            float(per_cam.max()), int(cams.sum()), worst, ", ".join(f"{float(per_cam[v]):.2e}" for v in worst),
            float((want.points_xyz - st.points_xyz)[pts].abs().max()), int(pts.sum()),
            int(want.points_valid.sum()), int(st.points_valid.sum()),
        )



def _bench_scene(workload, seed):
    """The benchmark's scene of `workload` at texture seed `seed`, rendered
    on the CPU (portbench/reference/scene.py), and the configuration's
    PipelineConfig overrides."""
    from portbench.harness import Bench
    from portbench.reference import scene as scene_mod

    bench = Bench(ROOT)
    config = bench.config(bench.cell(workload))
    return scene_mod.render(seed=seed, device="cpu", **config["scene"]), config.get("pipeline", {})


def _configured(config_module, overrides):
    """config_module.PipelineConfig() with the benchmark's "group.field"
    overrides applied (portbench/program.py pipeline_config)."""
    cfg = config_module.PipelineConfig()
    for key, value in overrides.items():
        group, _, field = key.partition(".")
        if field:
            value = dataclasses.replace(getattr(cfg, group), **{field: value})
        cfg = dataclasses.replace(cfg, **{group: value})
    return cfg


def bench(workload, seeds, packages, trail_dir):
    """Both packages on the CPU on one benchmark cell's scene at each
    texture seed (module docstring)."""
    import types

    from sfm_danpipeline_torch.io.calibration import Intrinsics
    from sfm_danpipeline_torch.io.images import ImageBatch

    for seed in seeds:
        sc, overrides = _bench_scene(workload, seed)
        V, H, W = sc.gray.shape
        images = ImageBatch(
            gray=sc.gray, color=np.repeat(sc.gray[..., None], 3, axis=-1),
            sizes=np.tile(np.array([[H, W]], np.int32), (V, 1)),
            paths=tuple(f"view_{v:04d}" for v in range(V)),
        )
        intrinsics = Intrinsics(K=sc.K.astype(np.float32), dist=np.zeros((5,), np.float32))
        scene = types.SimpleNamespace(images=images, intrinsics=intrinsics, centers=sc.centers)
        for package in packages:
            if package == "reference":
                from sfm_danpipeline_tpu import config as config_mod
                from sfm_danpipeline_tpu.pipeline import sfm as sfm_mod

                merge_name = "_merge_attempt_step"

                def merge_stats(a, ms):
                    return [int(v) for v in np.nonzero(np.asarray(a[3]))[0]], ring_capture.merge_stats(ms)
            else:
                from sfm_danpipeline_torch import config as config_mod
                from sfm_danpipeline_torch.pipeline import sfm as sfm_mod

                merge_name = "merge_attempt_step"

                def merge_stats(a, ms):
                    return list(a[3]), ms

            cfg = _configured(config_mod, overrides)
            kw = {}
            if package == "reference":
                pipe = sfm_mod.SfMPipeline(cfg)
            else:
                pipe = sfm_mod.SfMPipeline(cfg, device="cpu")
                if package == "injected":
                    from sfm_danpipeline_torch import interop
                    from sfm_danpipeline_tpu import config as j_config

                    kp, matches = _reference_front_end(scene, _configured(j_config, overrides))
                    fields = ("xy", "sigma", "angle", "response", "descriptors", "valid")
                    kw = dict(
                        precomputed_keypoints=interop.keypoints_from_numpy(
                            {k: np.asarray(getattr(kp, k)) for k in fields}
                        ),
                        precomputed_matches=interop.matches_from_numpy(
                            {k: np.asarray(getattr(matches, k)) for k in ("idx_a", "idx_b", "dist", "lowe", "valid")}
                        ),
                    )
            trail = _Trail()
            logger = logging.getLogger(sfm_mod.__name__.split(".")[0])
            logger.addHandler(trail)
            logger.setLevel(logging.INFO)
            tag = f"{workload} seed {seed}, {package}"
            t0 = time.time()
            try:
                with _instrument(sfm_mod.SfMPipeline, sfm_mod, merge_name, merge_stats) as (seed_log, merges):
                    try:
                        res = pipe.run(images, intrinsics, **kw)
                    except Exception as e:  # noqa: BLE001 - a raise is an outcome here
                        print(f"{tag}: raises {type(e).__name__}: {e}", flush=True)
                        res = None
                    if res is not None:
                        m = res.metrics
                        cams = res.state.cameras
                        cams = cams.cpu().numpy() if hasattr(cams, "cpu") else np.asarray(cams, np.float32)
                        print(f"{tag}: {_outcome(res, scene, cams)}", flush=True)
                        print(
                            f"{tag}: registered {sorted(res.registered_views)}, {m['n_components']} component(s), "
                            f"{m['n_merged_components']} merged, rotavg_applied {m.get('rotavg_applied')}, "
                            f"{ring_capture.keys_taken(pipe)} registration keys",
                            flush=True,
                        )
                        for views, ms in merges:
                            print(f"{tag}: merge of {views}: {_merge_line(ms)}", flush=True)
            finally:
                logger.removeHandler(trail)
            print(f"{tag}: {time.time() - t0:.1f} s", flush=True)
            if trail_dir:
                os.makedirs(trail_dir, exist_ok=True)
                with open(os.path.join(trail_dir, f"{workload}_seed{seed}_{package}.log"), "w") as f:
                    f.write("\n".join(trail.lines) + "\n")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    inj = sub.add_parser("injected")
    inj.add_argument("mode", choices=["flow", "guided", "ring"])
    inj.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    inj.add_argument("--float64-fits", action="store_true")
    for p in (inj, sub.add_parser("ring")):
        p.add_argument("--trail-dir", default=None, help="write each run's decision trail here")
        p.add_argument("--device", default="cpu", help="the port's device (cpu, or cuda for the card)")
        p.add_argument(
            "--front-end", default=None,
            help="injected: also save the reference's front end to this .npz; ring --package port: "
            "run the port on the front end saved there (no JAX needed)",
        )
        if p is not inj:
            p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
            p.add_argument("--package", choices=["reference", "port", "both"], default="both")
    rs = sub.add_parser("ring-step")
    rs.add_argument("view", type=int)
    rs.add_argument("--seed", type=int, default=0)
    rs.add_argument("--prev", type=int, default=None, help="the view registered just before it")
    ms = sub.add_parser("merge-step")
    ms.add_argument("--seed", type=int, default=0)
    ms.add_argument("--eager", action="store_true", help="also the reference op by op")
    ms.add_argument(
        "--ulps", type=int, default=0,
        help="also each package's merge BA on the reference's input scaled by 1 + k*1e-7, |k| <= ULPS",
    )
    pb = sub.add_parser("pair-basins")
    pb.add_argument("a", type=int)
    pb.add_argument("b", type=int)
    pb.add_argument("--views", type=int, default=20)
    pb.add_argument("--ring-fraction", type=float, default=0.4)
    pb.add_argument("--seed", type=int, default=0)
    bp = sub.add_parser("bench")
    bp.add_argument("--workload", default="arc20-sift.sparse")
    bp.add_argument("--seeds", type=int, nargs="+", required=True)
    bp.add_argument(
        "--package", nargs="+", choices=["reference", "port", "injected"], default=["reference", "port"],
        help="injected: the port on the reference's keypoints and matches",
    )
    bp.add_argument("--trail-dir", default=None, help="write each run's decision trail here")
    args = ap.parse_args()
    if args.cmd == "bench":
        return bench(args.workload, args.seeds, args.package, args.trail_dir)
    if args.cmd == "ring" or (args.cmd == "injected" and args.mode == "ring"):
        injected_ring = args.cmd == "injected"
        if injected_ring and args.float64_fits:
            _float64_fits()
        packages = ["port"] if injected_ring or args.package == "port" else (
            ["reference", "port"] if args.package == "both" else ["reference"]
        )
        return ring(args.seeds, packages, args.trail_dir, injected_ring, args.device, args.front_end)
    if args.cmd == "injected":
        return injected(args.mode, args.seeds, args.float64_fits)
    if args.cmd == "ring-step":
        return ring_step(args.seed, args.view, args.prev)
    if args.cmd == "merge-step":
        return merge_step(args.seed, args.eager, args.ulps)
    return pair_basins(args.a, args.b, args.views, args.ring_fraction, args.seed)


if __name__ == "__main__":
    sys.exit(main())
