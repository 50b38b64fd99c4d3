"""Deterministic top-k selection."""
from __future__ import annotations

import torch


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, lower index
    first on ties.

    top_k tie order: lax.top_k keeps the lower index first on ties, and the
    reference relies on it wherever entries tie (masked slots sharing a
    sentinel score, the two rows of a secondary-orientation keypoint,
    duplicate RANSAC hypotheses). torch.topk promises no order among ties,
    so this is a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
