"""Camera calibration loading.

Reference behavior: `StructFromMotion::getCameraMatrix` (src/Sfm.cpp:203-252)
parses an OpenCV FileStorage XML holding `Camera_Matrix` (3x3) and
`Distortion_Coefficients` (1x5) into `Intrinsics {K, distCoef}`
(include/Utilities.h:30-35), validating that K is non-empty.

We parse the same XML format without OpenCV. A copy of
sfm_danpipeline_tpu/io/calibration.py, kept so the port never imports the
JAX package.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics. K is 3x3 row-major; dist is the 5-vector
    (k1, k2, p1, p2, k3) in OpenCV ordering."""

    K: np.ndarray
    dist: np.ndarray

    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    @property
    def cx(self) -> float:
        return float(self.K[0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[1, 2])

    def scaled(self, factor: float) -> "Intrinsics":
        """Rescale intrinsics when images are resized by `factor`
        (the reference resizes images at src/Sfm.cpp:150-160 but keeps K
        unchanged — a latent bug; we scale K consistently and document the
        divergence)."""
        K = self.K.copy()
        K[0, :] *= factor
        K[1, :] *= factor
        return Intrinsics(K=K, dist=self.dist)


def _parse_opencv_matrix(node: ET.Element) -> np.ndarray:
    rows = int(node.findtext("rows"))
    cols = int(node.findtext("cols"))
    data = np.fromstring(node.findtext("data"), sep=" ", dtype=np.float64)
    if data.size != rows * cols:
        raise ValueError(
            f"matrix data has {data.size} entries, expected {rows}x{cols}"
        )
    return data.reshape(rows, cols)


def load_calibration(path: str) -> Intrinsics:
    """Parse an OpenCV FileStorage XML calibration file.

    Mirrors src/Sfm.cpp:203-252: reads Camera_Matrix and
    Distortion_Coefficients, raising if the camera matrix is missing/empty
    (reference aborts at src/Sfm.cpp:216,246).
    """
    tree = ET.parse(path)
    root = tree.getroot()
    K = None
    dist = np.zeros(5, dtype=np.float64)
    for node in root.iter():
        if node.tag == "Camera_Matrix":
            K = _parse_opencv_matrix(node)
        elif node.tag == "Distortion_Coefficients":
            dist = _parse_opencv_matrix(node).reshape(-1)
    if K is None or K.shape != (3, 3) or not np.isfinite(K).all():
        raise ValueError(f"no valid 3x3 Camera_Matrix found in {path}")
    if dist.size < 5:
        dist = np.pad(dist, (0, 5 - dist.size))
    return Intrinsics(K=K.astype(np.float64), dist=dist[:5].astype(np.float64))
