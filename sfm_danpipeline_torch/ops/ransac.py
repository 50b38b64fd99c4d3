"""Fixed-budget RANSAC building blocks.

Port of sfm_danpipeline_tpu/ops/ransac.py: a fixed number of hypotheses,
each fit from a random minimal sample, all scored in one batched pass,
selected by MSAC (sum of truncated residuals).

RNG: the port cannot reproduce JAX's threefry keys. Draws come from an
explicit `torch.Generator` (seeded by the pipeline from
config.geometry.seed), and every estimator takes an optional `samples`
argument holding injected (n_hypotheses, sample_size) index draws, so
parity tests feed both implementations the same samples.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def sample_indices(
    gen: Optional[torch.Generator],
    valid: torch.Tensor,
    n_hypotheses: int,
    sample_size: int,
) -> torch.Tensor:
    """Draw (n_hypotheses, sample_size) indices of valid entries, uniformly
    with replacement across draws. valid: (M,) mask."""
    count = torch.clamp(torch.sum(valid.to(torch.int64)), min=1)
    # Valid indices first, in their original (stable) order.
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    u = torch.rand(
        (n_hypotheses, sample_size), generator=gen, device=valid.device
    )
    r = torch.clamp((u * count).long(), max=count - 1)
    return order[r]


def ransac(
    gen: Optional[torch.Generator],
    fit: Callable[[torch.Tensor], torch.Tensor],
    residuals: Callable[[torch.Tensor], torch.Tensor],
    valid: torch.Tensor,
    n_hypotheses: int,
    sample_size: int,
    threshold: float | torch.Tensor,
    samples: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-budget MSAC.

    fit(idx (H, s)) -> models (H, ...); residuals(models) -> (H, M)
    nonnegative residuals. Returns (best_model, inlier_mask (M,),
    inlier_count) with inliers = residual < threshold among valid entries.
    """
    idx = (
        samples if samples is not None
        else sample_indices(gen, valid, n_hypotheses, sample_size)
    )
    models = fit(idx)
    res = residuals(models)
    res = torch.where(valid[None, :], res, torch.zeros_like(res))
    scores = torch.sum(torch.clamp(res, max=threshold), dim=-1)
    best = torch.argmin(scores)
    mask = (res[best] < threshold) & valid
    return models[best], mask, torch.sum(mask)
