"""Non-blocking visualization artifacts.

The reference gates its pipeline on blocking cv/PCL viewers (keypoints at
src/Sfm.cpp:276-296, matches at 416-464, clouds at 52-59/86-90, mesh at
1385-1397, segmentation at Segmentation.cpp:59-64). Per SURVEY.md §7
non-goals, those become PNG dumps: same information, nothing blocks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return img


def draw_keypoints(
    path: str,
    image: np.ndarray,
    xy: np.ndarray,
    valid: Optional[np.ndarray] = None,
    sigma: Optional[np.ndarray] = None,
) -> None:
    """Keypoint overlay PNG (the reference's keypoint window,
    src/Sfm.cpp:276-296)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(_to_u8(np.asarray(image)))
    d = ImageDraw.Draw(img)
    xy = np.asarray(xy)
    if valid is not None:
        xy = xy[np.asarray(valid)]
        sigma = np.asarray(sigma)[np.asarray(valid)] if sigma is not None else None
    for i, (x, y) in enumerate(xy):
        r = float(sigma[i]) if sigma is not None else 2.0
        d.ellipse([x - r, y - r, x + r, y + r], outline=(0, 255, 0))
    img.save(path)


def draw_matches(
    path: str,
    image_a: np.ndarray,
    image_b: np.ndarray,
    xy_a: np.ndarray,
    xy_b: np.ndarray,
    valid: Optional[np.ndarray] = None,
    max_lines: int = 200,
) -> None:
    """Side-by-side match visualization (the reference's "Matching pairs"
    window, src/Sfm.cpp:505-531)."""
    from PIL import Image, ImageDraw

    a = _to_u8(np.asarray(image_a))
    b = _to_u8(np.asarray(image_b))
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    img = Image.fromarray(canvas)
    d = ImageDraw.Draw(img)
    xa = np.asarray(xy_a)
    xb = np.asarray(xy_b)
    if valid is not None:
        v = np.asarray(valid)
        xa, xb = xa[v], xb[v]
    off = a.shape[1]
    for i in range(min(len(xa), max_lines)):
        d.line(
            [xa[i, 0], xa[i, 1], xb[i, 0] + off, xb[i, 1]],
            fill=(255, 160, 0),
            width=1,
        )
    img.save(path)


def save_depth_map(path: str, depth: np.ndarray) -> None:
    """Depth map PNG (normalized inferno colormap; invalid=black)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm

    d = np.asarray(depth, np.float64).copy()
    m = d > 0
    if m.any():
        lo, hi = np.percentile(d[m], [2, 98])
        d = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    rgba = cm.inferno(d)
    rgba[~m] = 0
    from PIL import Image

    Image.fromarray((rgba[..., :3] * 255).astype(np.uint8)).save(path)


def save_cloud_views(
    path: str, points: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """Three orthographic scatter projections of a cloud (the reference's
    CloudViewer analogue, src/Sfm.cpp:52-59)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    c = np.clip(np.asarray(colors), 0, 1) if colors is not None else None
    fig, axes = plt.subplots(1, 3, figsize=(14, 5))
    for ax, (i, j, name) in zip(
        axes, [(0, 1, "XY"), (0, 2, "XZ"), (1, 2, "YZ")]
    ):
        ax.scatter(pts[:, i], pts[:, j], s=0.5, c=c, linewidths=0)
        ax.set_title(name)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
