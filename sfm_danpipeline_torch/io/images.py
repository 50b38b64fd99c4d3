"""Image directory loading and preprocessing.

A copy of sfm_danpipeline_tpu/io/images.py (numpy only; PIL is imported
inside `load_images`), kept so the port never imports the JAX package.

Reference behavior: `StructFromMotion::imagesLOAD` (src/Sfm.cpp:118-198):
scan a directory for .jpg/.png (sorted), imread each, downscale by 0.6x when
larger than 640x480, keep both a grayscale and a color copy, and require at
least 2 images (src/Sfm.cpp:172).

TPU-first design: all images are decoded host-side into one fixed-shape
float32 batch (N, H, W) grayscale + (N, H, W, 3) color, padded to a common
H x W so every downstream kernel sees static shapes. Grayscale uses the
ITU-R BT.601 weights (OpenCV's cvtColor BGR2GRAY convention).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

from sfm_danpipeline_torch.config import ImageConfig

_EXTENSIONS = (".jpg", ".jpeg", ".png")


@dataclasses.dataclass(frozen=True)
class ImageBatch:
    """Fixed-shape image batch.

    gray:  (N, H, W)    float32 in [0, 1]
    color: (N, H, W, 3) float32 in [0, 1], RGB
    sizes: (N, 2)       int32, valid (height, width) per image before padding
    paths: source file paths (host metadata, not traced)
    """

    gray: np.ndarray
    color: np.ndarray
    sizes: np.ndarray
    paths: Tuple[str, ...]

    @property
    def n_images(self) -> int:
        return self.gray.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.gray.shape[1], self.gray.shape[2]


def list_image_files(directory: str) -> List[str]:
    """Sorted image paths in a directory (reference sorts at src/Sfm.cpp:137)."""
    files = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.lower().endswith(_EXTENSIONS)
    )
    return files


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    # BT.601 luma, matching OpenCV cvtColor.
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.float32)


def load_images(
    directory: str,
    config: ImageConfig = ImageConfig(),
    paths: Sequence[str] | None = None,
) -> ImageBatch:
    """Load, optionally downscale, grayscale, and pad a directory of images.

    Matches src/Sfm.cpp:118-198 semantics: sorted scan, 0.6x resize when the
    image exceeds 640x480, and a >=2 image requirement.
    """
    from PIL import Image  # imported here so the package imports without PIL

    if paths is None:
        paths = list_image_files(directory)
    if len(paths) < 2:
        raise ValueError(
            f"need at least 2 images, found {len(paths)} in {directory}"
        )

    colors: List[np.ndarray] = []
    sizes: List[Tuple[int, int]] = []
    for p in paths:
        im = Image.open(p).convert("RGB")
        w, h = im.size
        if w > config.max_width or h > config.max_height:
            w = int(round(w * config.resize_factor))
            h = int(round(h * config.resize_factor))
            im = im.resize((w, h), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.float32) / 255.0
        colors.append(arr)
        sizes.append((h, w))

    H = max(s[0] for s in sizes)
    W = max(s[1] for s in sizes)
    n = len(colors)
    color = np.zeros((n, H, W, 3), dtype=np.float32)
    for i, arr in enumerate(colors):
        h, w = sizes[i]
        color[i, :h, :w] = arr
    gray = _to_gray(color)
    return ImageBatch(
        gray=gray,
        color=color,
        sizes=np.asarray(sizes, dtype=np.int32),
        paths=tuple(paths),
    )
