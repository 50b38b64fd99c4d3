"""Compute primitives in PyTorch: features, matching (with the hand-written
CUDA top-2 kNN kernel), epipolar geometry, triangulation and PnP."""
