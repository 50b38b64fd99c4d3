"""The benchmark of sfm_danpipeline_torch (see README.md)."""
