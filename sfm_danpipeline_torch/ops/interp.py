"""Bilinear sampling / gather helpers used by the feature code.

Port of sfm_danpipeline_tpu/ops/interp.py. All samplers clamp to the image
border.
"""
from __future__ import annotations

import torch


def bilinear_sample(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Sample img (H, W) at fractional positions (x, y) with clamping."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0.to(img.dtype)
    fy = y - y0.to(img.dtype)
    flat = img.reshape(-1)
    return (
        flat[y0 * W + x0] * (1 - fx) * (1 - fy)
        + flat[y0 * W + x1] * fx * (1 - fy)
        + flat[y1 * W + x0] * (1 - fx) * fy
        + flat[y1 * W + x1] * fx * fy
    )


def bilinear_sample_level(
    stack: torch.Tensor, level: torch.Tensor, x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Sample stack (S, H, W) at integer level and fractional (x, y);
    `level` broadcasts against x and y."""
    S, H, W = stack.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0.to(stack.dtype)
    fy = y - y0.to(stack.dtype)
    base = torch.clamp(level.long(), 0, S - 1) * (H * W)
    flat = stack.reshape(-1)
    return (
        flat[base + y0 * W + x0] * (1 - fx) * (1 - fy)
        + flat[base + y0 * W + x1] * fx * (1 - fy)
        + flat[base + y1 * W + x0] * (1 - fx) * fy
        + flat[base + y1 * W + x1] * fx * fy
    )


def gather_cube(
    vol: torch.Tensor, s: torch.Tensor, y: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """The 3x3x3 neighborhood of vol (S, H, W) around integer centers
    s, y, x (K,). Returns (K, 3, 3, 3) ordered [ds, dy, dx]."""
    S, H, W = vol.shape
    offs = torch.arange(-1, 2, device=vol.device)
    ss = torch.clamp(s[:, None, None, None] + offs[None, :, None, None], 0, S - 1)
    yy = torch.clamp(y[:, None, None, None] + offs[None, None, :, None], 0, H - 1)
    xx = torch.clamp(x[:, None, None, None] + offs[None, None, None, :], 0, W - 1)
    return vol.reshape(-1)[(ss * H + yy) * W + xx]


def bilinear_sample_batch(
    imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """bilinear_sample over a batch: imgs (N, H, W), x and y (N, ...) ->
    samples of image n at its own positions, clamped to the border."""
    N, H, W = imgs.shape
    n = torch.arange(N, device=imgs.device).reshape((N,) + (1,) * (x.dim() - 1))
    return bilinear_sample_level(imgs, n, x, y)
