#!/usr/bin/env python3
"""Either package's SfMPipeline with guided bridging on, for its quality
numbers on the rendered courtyard arc.

    JAX_PLATFORMS=cpu python3 tools/guided_arc.py [--views 20] [--ring-fraction 0.4] [--seed 0]
    python3 tools/guided_arc.py --port [--device cuda|cpu] [--views 20] ...

Runs SfMPipeline with `geometry.guided_enable=True`, `geometry.seed` set to
`--seed` (the RANSAC draws) and otherwise the default config on `make_courtyard_scene(n_views, ring_fraction, seed=0)`
(480x640) and prints one JSON line: registered views, the views registered
by the guided bridge, whether the block realign was applied, the final BA
RMS, the point count, the trajectory error after similarity alignment as a
percentage of the ground-truth diameter, and the run's wall time. Without
`--port` it runs the JAX reference (sfm_danpipeline_tpu; on a CPU as shown),
whose numbers `chip_smoke.py` phase 13 holds the port to (REF_GUIDED); with
`--port` it runs sfm_danpipeline_torch and imports nothing of JAX.
"""
import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--ring-fraction", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=0, help="geometry.seed: the RANSAC draws")
    ap.add_argument("--port", action="store_true", help="run sfm_danpipeline_torch")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("-v", "--verbose", action="store_true", help="log every registration")
    args = ap.parse_args()
    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(levelname).1s %(message)s")
    if args.port:
        from sfm_danpipeline_torch.config import PipelineConfig
        from sfm_danpipeline_torch.pipeline.sfm import SfMPipeline
        from sfm_danpipeline_torch.utils.metrics import aligned_rmse, camera_centers
        from sfm_danpipeline_torch.utils.synthscene import make_courtyard_scene

        def pipeline(cfg):
            return SfMPipeline(cfg, device=args.device)

        def cameras(res):
            return res.state.cameras.cpu().numpy()
    else:
        from sfm_danpipeline_tpu.config import PipelineConfig
        from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline
        from sfm_danpipeline_tpu.utils.metrics import aligned_rmse, camera_centers
        from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene

        pipeline = SfMPipeline

        def cameras(res):
            return np.asarray(res.state.cameras, np.float32)

    scene = make_courtyard_scene(n_views=args.views, ring_fraction=args.ring_fraction, seed=0)
    base = PipelineConfig()
    cfg = dataclasses.replace(
        base, geometry=dataclasses.replace(base.geometry, guided_enable=True, seed=args.seed)
    )
    t0 = time.time()
    res = pipeline(cfg).run(scene.images, scene.intrinsics)
    wall = time.time() - t0
    regs = sorted(res.registered_views)
    c = camera_centers(cameras(res))[regs]
    g = scene.centers[regs]
    ate_pct = 100.0 * aligned_rmse(c, g) / float(np.linalg.norm(g.max(0) - g.min(0)))
    m = res.metrics
    out = {"package": "sfm_danpipeline_torch" if args.port else "sfm_danpipeline_tpu", "seed": args.seed}
    out.update({k: m.get(k) for k in (
        "n_registered", "n_guided_registered", "block_realign_applied", "ba_rms_px",
        "n_points", "n_components", "n_merged_components",
    )})
    out.update(ate_pct=ate_pct, registered=regs, wall_s=wall)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
