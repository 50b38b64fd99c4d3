"""PMVS2 input-tree exporter (debugging/interop artifact).

The reference drives its dense stage by writing a PMVS2 filesystem protocol
(`StructFromMotion::PMVS2`, src/Sfm.cpp:1246-1303): denseCloud/{visualize,
txt,models}, an options.txt (src/Sfm.cpp:1258-1264), per-view projection
files "CONTOUR\\nK[R|t]" (src/Sfm.cpp:1287-1300), and copies of the images.
Our dense stage is in-process (mvs/), but this exporter reproduces the
exact on-disk format so users can cross-check against a real PMVS2 binary
or other tools that consume the protocol (SURVEY.md §7 step 6).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from sfm_danpipeline_torch.io.calibration import Intrinsics
from sfm_danpipeline_torch.io.images import ImageBatch


def export_pmvs(
    out_dir: str,
    images: ImageBatch,
    intrinsics: Intrinsics,
    R: np.ndarray,  # (V, 3, 3) world->cam
    t: np.ndarray,  # (V, 3)
    registered: Sequence[int],
    level: int = 1,
    csize: int = 2,
    threshold: float = 0.7,
    wsize: int = 7,
    min_image_num: int | None = None,
    cpu: int = 4,
) -> str:
    """Write the denseCloud/ tree. Returns the options file path.

    Option defaults mirror src/Sfm.cpp:1258-1264 (level 1, csize 2,
    threshold 0.7, wsize 7, CPU 4, minImageNum 5-with-10-images scaled as
    max(2, n//2) when unset).
    """
    from PIL import Image  # only this exporter needs PIL

    root = os.path.join(out_dir, "denseCloud")
    for sub in ("visualize", "txt", "models"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    n = len(registered)
    if min_image_num is None:
        min_image_num = max(2, n // 2)

    with open(os.path.join(root, "options.txt"), "w") as f:
        f.write(f"timages -1 0 {n}\n")
        f.write("oimages 0\n")
        f.write(f"level {level}\n")
        f.write(f"csize {csize}\n")
        f.write(f"threshold {threshold}\n")
        f.write(f"wsize {wsize}\n")
        f.write(f"minImageNum {min_image_num}\n")
        f.write(f"CPU {cpu}\n")

    K = intrinsics.K
    for out_idx, v in enumerate(registered):
        # Image copy (the reference shells out `cp`, src/Sfm.cpp:1283-1284;
        # we write the decoded pixels directly).
        img = (np.asarray(images.color[v]) * 255).astype(np.uint8)
        Image.fromarray(img).save(
            os.path.join(root, "visualize", f"{out_idx:04d}.jpg")
        )
        # Projection file: "CONTOUR" + K [R|t] (src/Sfm.cpp:1287-1300).
        P = K @ np.concatenate([R[v], t[v][:, None]], axis=1)
        with open(
            os.path.join(root, "txt", f"{out_idx:04d}.txt"), "w"
        ) as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")
    return os.path.join(root, "options.txt")
