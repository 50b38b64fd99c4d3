"""Slice-level parity of the port's other front ends with the JAX
reference: both packages' `SfMPipeline.run` on the rendered V=6 courtyard
(240x320, ring_fraction 0.12, max_keypoints 1024) with the AKAZE and the ORB
detector at the CLI's ratio of 0.9, and (in tests/test_torch_flow.py, which
shares the check) on four views of a narrower arc with the LK-flow matcher:
flow cannot bridge the V=6 baseline.

The runs cannot agree bitwise (both draw the same RANSAC samples from one
seed, but the front ends' floats round differently, and a draw picks a
match slot, so slots ordered by a near-tied float can hold other matches),
so they are held at the level of the run's metrics: the
same views registered in one component, the same keypoint yield (to 1%),
final BA RMS within 0.3 px of each other and under 1.5 px on both sides
(AKAZE 0.52 / 0.35 px, ORB 0.40 / 0.40 px, flow 0.93 / 1.10 px when this was
written; the 34-degree field of view of the small scene conditions the
geometry poorly, so no trajectory gate is applied here), point counts
within 15%. The port runs on the CPU, where `knn2` is `knn2_torch`.
"""
import pytest

from torch_testing import one_torch_thread  # noqa: F401
from torch_v6_reference import check_front_end


@pytest.mark.parametrize("detector", ["akaze", "orb"])
def test_front_end_matches_reference(detector):
    check_front_end(detector, "bf")
