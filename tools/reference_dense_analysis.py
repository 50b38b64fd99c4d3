#!/usr/bin/env python3
"""The JAX reference's filter and dendrometry stages on a cloud that another
run wrote, to tell a gap in those stages from a gap in the cloud.

    JAX_PLATFORMS=cpu python3 tools/reference_dense_analysis.py DENSE_PLY

reads DENSE_PLY (for example the dense.ply that `python3
tools/torch_stage_probe.py cli-akaze` leaves), runs the reference command
line's filter stage on it with the default config (the PassThrough window and
the radius-outlier removal, each skipped or rescaled by the same gauge guards
as sfm_danpipeline_tpu/cli.py) and dendrometry on what the filter keeps, and
prints one JSON line: the dense, filtered and dendrometry numbers.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import jax.numpy as jnp

    from sfm_danpipeline_tpu.analysis.dendrometry import estimate
    from sfm_danpipeline_tpu.analysis.filtering import passthrough_mask, radius_outlier_mask
    from sfm_danpipeline_tpu.config import PipelineConfig
    from sfm_danpipeline_tpu.io.ply import read_ply

    points, _ = read_ply(sys.argv[1])
    a = PipelineConfig().analysis
    pts = jnp.asarray(points, jnp.float32)
    valid = jnp.ones(len(points), bool)
    m = passthrough_mask(pts, a.passthrough_axis, a.passthrough_min, a.passthrough_max, valid)
    passthrough_used = float(jnp.mean(m)) >= 0.05
    if passthrough_used:
        valid = m
    diag = float(np.linalg.norm(points.max(0) - points.min(0)))
    radius, min_nb = a.outlier_radius, a.outlier_min_neighbors
    m = radius_outlier_mask(pts, valid, radius, min_nb)
    if float(jnp.sum(m)) < 0.05 * float(jnp.sum(valid)):
        radius, min_nb = 0.01 * diag, 3
        m = radius_outlier_mask(pts, valid, radius, min_nb)
    keep = np.asarray(m)
    rep = estimate(jnp.asarray(points[keep]), jnp.ones(int(keep.sum()), bool))
    print(json.dumps({
        "package": "sfm_danpipeline_tpu", "cloud": sys.argv[1], "n_dense": len(points),
        "passthrough_used": passthrough_used, "outlier_radius": radius, "outlier_min_neighbors": min_nb,
        "n_filtered": int(keep.sum()), "dendrometry": rep,
    }))


if __name__ == "__main__":
    main()
