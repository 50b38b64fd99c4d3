"""Build and load the hand-written CUDA kernels in `csrc/`.

Each kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C entry point and loaded with ctypes. The build happens at
first use, never at import, into `_build/` beside this file (listed in
.gitignore), keyed by a hash of the source and the flags, so an edited
source rebuilds (in the next process: a loaded library is kept by name) and
an unchanged one loads the library already built. nvcc's output, with what
ptxas reports for each kernel (registers, spills), is kept beside the library
(`<library>.log`), so `ptxas_report` also answers for a library built earlier.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}  # kernel name -> loaded ctypes library


def nvcc() -> str:
    """Path of the nvcc that builds the kernels."""
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "sfm_danpipeline_torch are built from source at first use"
    )


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu at its current content
    and flags."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def ptxas_lines(log: str) -> list:
    """The lines of nvcc's output that give each kernel's registers, shared
    memory and spills."""
    keep = ("Compiling entry", "registers", "spill")
    return [
        line.replace("ptxas info    : ", "").strip()
        for line in log.splitlines() if any(k in line for k in keep)
    ]


def ptxas_report(name: str) -> list:
    """What ptxas said when csrc/<name>.cu was built: one line per kernel
    with its registers, shared memory and spills."""
    with open(library_path(name) + ".log") as f:
        return ptxas_lines(f.read())


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; returns the ctypes library."""
    lib = _loaded.get(name)  # without hashing the source again
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # Build to a temporary name and rename: a concurrent or interrupted
        # build never leaves a partial library at `path`.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        source = os.path.join(CSRC, name + ".cu")
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, source], capture_output=True, text=True
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}"
            )
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    lib = _loaded[name] = ctypes.CDLL(path)
    return lib
