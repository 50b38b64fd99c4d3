"""ctypes bindings for the native cloud runtime (native/cloudio.cpp).

Copy of the reference package's binding; both load the same
`native/libcloudio.so` at the repository root. Builds on demand with
`make -C native` (g++). Host file I/O only: every entry point has a pure
Python/numpy fallback where no toolchain exists; `available()` reports
which path is active.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("sfm_danpipeline_torch.native")

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcloudio.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(
        os.path.join(_NATIVE_DIR, "Makefile")
    ):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception as e:  # pragma: no cover
            log.warning("native build failed (%s); using Python fallbacks", e)
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.write_ply_binary.restype = ctypes.c_int
    lib.write_ply_binary.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.ply_vertex_count.restype = ctypes.c_int64
    lib.ply_vertex_count.argtypes = [ctypes.c_char_p]
    lib.read_ply_binary.restype = ctypes.c_int64
    lib.read_ply_binary.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.voxel_downsample_idx.restype = ctypes.c_int64
    lib.voxel_downsample_idx.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.radius_neighbor_counts.restype = None
    lib.radius_neighbor_counts.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_ply_fast(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """Binary PLY write; native when available, else Python fallback."""
    points = np.ascontiguousarray(points, np.float32)
    cols = None
    if colors is not None:
        cols = np.ascontiguousarray(
            np.clip(
                colors * 255.0 if colors.dtype != np.uint8 else colors, 0, 255
            ),
            np.uint8,
        )
    lib = _load()
    if lib is not None:
        rc = lib.write_ply_binary(
            path.encode(),
            _fptr(points),
            cols.ctypes.data_as(ctypes.c_void_p) if cols is not None else None,
            len(points),
        )
        if rc == 0:
            return
        log.warning("native write_ply_binary rc=%d; falling back", rc)
    from sfm_danpipeline_torch.io.ply import write_ply

    write_ply(path, points, cols)


def read_ply_fast(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    lib = _load()
    if lib is not None:
        n = lib.ply_vertex_count(path.encode())
        if n > 0:
            pts = np.empty((n, 3), np.float32)
            cols = np.empty((n, 3), np.uint8)
            got = lib.read_ply_binary(
                path.encode(), _fptr(pts),
                cols.ctypes.data_as(ctypes.c_void_p), n,
            )
            if got == n:
                return pts, cols
    from sfm_danpipeline_torch.io.ply import read_ply

    return read_ply(path)


def voxel_downsample_fast(
    points: np.ndarray, voxel: float
) -> np.ndarray:
    """Kept-index array of a voxel-grid downsample (first point per voxel)."""
    points = np.ascontiguousarray(points, np.float32)
    lib = _load()
    if lib is not None:
        idx = np.empty(len(points), np.int64)
        kept = lib.voxel_downsample_idx(
            _fptr(points), len(points), voxel,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return idx[:kept]
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return np.sort(idx)


def radius_neighbor_counts_fast(
    points: np.ndarray, radius: float
) -> np.ndarray:
    """Grid-accelerated neighbor counts (host path for huge clouds)."""
    points = np.ascontiguousarray(points, np.float32)
    lib = _load()
    if lib is not None:
        counts = np.empty(len(points), np.int32)
        lib.radius_neighbor_counts(
            _fptr(points), len(points), radius,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return counts
    d = np.linalg.norm(points[:, None] - points[None], axis=-1)
    return ((d <= radius).sum(1) - 1).astype(np.int32)
