"""Dense stage: rectified and direct plane sweeps, depth-map fusion and
the `densify` driver."""
