#!/usr/bin/env python3
"""The JAX reference's LK-flow path over RANSAC seeds, for its quality
numbers (run it on a CPU: `JAX_PLATFORMS=cpu python3 tools/reference_flow_seeds.py`).

    python3 tools/reference_flow_seeds.py [--seeds 0 1 2 ...]

Runs sfm_danpipeline_tpu's SfMPipeline with `method="flow"` on the narrow
V=10 courtyard arc (480x640, ring_fraction 0.05, scene seed 0) once per
`geometry.seed` and prints registered views, the seed pair, RMS, points and
the trajectory error of each run, or that no seed pair survived. The port's
counterpart is `tools/torch_stage_probe.py flow-seeds` (on a CUDA card, or
with `--device cpu`); both packages draw the same RANSAC samples from one
seed, so the runs are compared seed for seed.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sfm_danpipeline_tpu.config import PipelineConfig  # noqa: E402
from sfm_danpipeline_tpu.pipeline.sfm import SfMPipeline  # noqa: E402
from sfm_danpipeline_tpu.utils.metrics import aligned_rmse, camera_centers  # noqa: E402
from sfm_danpipeline_tpu.utils.synthscene import make_courtyard_scene  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args()
    scene = make_courtyard_scene(n_views=10, ring_fraction=0.05, seed=0)
    base = PipelineConfig()
    ates = []
    for seed in args.seeds:
        cfg = dataclasses.replace(
            base,
            matching=dataclasses.replace(base.matching, method="flow"),
            geometry=dataclasses.replace(base.geometry, seed=seed),
        )
        try:
            res = SfMPipeline(cfg).run(scene.images, scene.intrinsics)
        except RuntimeError as e:
            print(f"reference flow seed {seed}: failed: {e}", flush=True)
            continue
        m = res.metrics
        regs = sorted(res.registered_views)
        c = camera_centers(np.asarray(res.state.cameras, np.float32))[regs]
        g = scene.centers[regs]
        ates.append(100 * aligned_rmse(c, g) / float(np.linalg.norm(g.max(0) - g.min(0))))
        print(
            "reference flow seed %d: registered %d/10, seed pair (%d, %d), RMS %.4f px, "
            "%d points, ATE %.3f%% of diameter"
            % (
                seed, m["n_registered"], m["baseline_pair_i"], m["baseline_pair_j"],
                m["ba_rms_px"], m["n_points"], ates[-1],
            ),
            flush=True,
        )
    print(
        "reference flow seeds: %d of %d ran to their end, median ATE %s%%"
        % (len(ates), len(args.seeds), "%.3f" % np.median(ates) if ates else "n/a")
    )


if __name__ == "__main__":
    main()
