"""Point-cloud file formats: PLY and PCD.

The reference round-trips its clouds through disk: PMVS2 writes a PLY
(src/Sfm.cpp:70-76), which is converted and saved as `MAP3D.pcd`
(src/Sfm.cpp:80) — the on-disk interface between the SfM stage and
Segmentation (src/Segmentation.cpp:8). We provide the same formats so users
of the reference find equivalent artifacts, but in-process stages pass
arrays directly (SURVEY.md §7 non-goals: no file-plumbing between stages).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """Write an ASCII PLY. points (N,3) float; colors (N,3) float [0,1] or uint8."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            x, y, z = points[i]
            if has_color:
                r, g, b = colors[i]
                f.write(f"{x} {y} {z} {r} {g} {b}\n")
            else:
                f.write(f"{x} {y} {z}\n")


_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY (ascii or binary_little_endian) with x y z [r g b]
    vertex properties — covers both our ASCII writer and the native
    runtime's binary writer (native/cloudio.cpp)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        n = 0
        fmt = "ascii"
        props: list = []  # (name, type) of the vertex element
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii", "replace")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                _, ptype, pname = line.split()
                props.append((pname, ptype))
            elif line == "end_header":
                break
        names = [p[0] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n, ndmin=2)
            cols = {nm: data[:, i] for i, (nm, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype(
                [(nm, _PLY_DTYPES[tp]) for nm, tp in props]
            )
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
            cols = {nm: rec[nm] for nm in names}
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    points = np.stack(
        [cols[c] for c in ("x", "y", "z")], axis=-1
    ).astype(np.float32)
    colors = None
    if all(c in names for c in ("red", "green", "blue")):
        colors = np.stack(
            [cols[c] for c in ("red", "green", "blue")], axis=-1
        ).astype(np.uint8)
    return points, colors


def write_pcd(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """Write an ASCII PCD v0.7 (the `MAP3D.pcd` format, src/Sfm.cpp:80)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        if has_color:
            f.write("FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n")
        else:
            f.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        for i in range(n):
            x, y, z = points[i]
            if has_color:
                r, g, b = colors[i]
                packed = (int(r) << 16) | (int(g) << 8) | int(b)
                rgbf = np.frombuffer(
                    np.uint32(packed).tobytes(), dtype=np.float32
                )[0]
                f.write(f"{x} {y} {z} {rgbf:.9g}\n")
            else:
                f.write(f"{x} {y} {z}\n")


def read_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read an ASCII PCD with x y z [rgb packed-float] fields."""
    fields = []
    n = 0
    with open(path, "r") as f:
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PCD header")
            line = line.strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                if line.split()[1] != "ascii":
                    raise ValueError(f"{path}: only ascii PCD supported")
                break
        data = np.loadtxt(f, max_rows=n, ndmin=2)
    xyz_idx = [fields.index(c) for c in ("x", "y", "z")]
    points = data[:, xyz_idx].astype(np.float32)
    colors = None
    if "rgb" in fields:
        packed = data[:, fields.index("rgb")].astype(np.float32)
        as_u32 = packed.view(np.uint32) if packed.flags["C_CONTIGUOUS"] else np.ascontiguousarray(packed).view(np.uint32)
        colors = np.stack(
            [(as_u32 >> 16) & 0xFF, (as_u32 >> 8) & 0xFF, as_u32 & 0xFF], axis=-1
        ).astype(np.uint8)
    return points, colors
