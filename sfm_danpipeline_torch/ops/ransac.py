"""Fixed-budget RANSAC building blocks.

Port of sfm_danpipeline_tpu/ops/ransac.py: a fixed number of hypotheses,
each fit from a random minimal sample, all scored in one batched pass,
selected by MSAC (sum of truncated residuals). Every block takes optional
leading batch dims (a pair axis), so that many independent problems run as
one computation; one problem is the case with no leading dims.

Draws: every estimator takes a key of the reference's threefry tree
(ops/prng.py), one per problem along the leading dims, and draws the same
indices as the reference's `sample_indices` does from that key, on the CPU
and on a card alike. Every estimator also takes an optional `samples`
argument holding injected (..., n_hypotheses, sample_size) index draws.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sfm_danpipeline_torch.ops import prng
from sfm_danpipeline_torch.ops.reduce import fixed_sum

# cuSOLVER's batched eigh refused 65,536 matrices on the H100, so batched
# factorizations go in slices this size.
LINALG_BATCH = 8192


def sample_indices(
    key: torch.Tensor,
    valid: torch.Tensor,
    n_hypotheses: int,
    sample_size: int,
) -> torch.Tensor:
    """Draw (..., n_hypotheses, sample_size) indices of valid entries,
    uniformly with replacement across draws, as the reference does from the
    same key: `randint` over the valid count, read through the valid rows
    in their stable order. valid: (..., M) mask and key (..., 2), one key
    per problem; every problem draws from its own valid set, all in one
    call. The random words are hashed on the key's device and folded on
    valid's."""
    lead = valid.shape[:-1]
    if tuple(key.shape) != tuple(lead) + (2,):
        raise ValueError(f"{tuple(lead)} problems need keys {tuple(lead) + (2,)}, got {tuple(key.shape)}")
    if valid.shape[-1] >= 2**31:
        raise ValueError("sample_indices draws from at most 2**31 - 1 rows")
    count = torch.clamp(torch.sum(valid.to(torch.int64), dim=-1), min=1)
    count = count.reshape(lead + (1, 1))
    # Valid indices first, in their original (stable) order.
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    bits = prng.randint_bits(key, (n_hypotheses, sample_size))
    if bits.device != valid.device:
        bits = bits.pin_memory() if valid.device.type == "cuda" else bits
        bits = bits.to(valid.device, non_blocking=True)
    r = prng.fold_bits(bits[..., 0, :, :], bits[..., 1, :, :], count)
    return gather_rows(order[..., None], r)[..., 0]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (..., M, C) at idx (..., H, s) -> (..., H, s, C), one
    problem's indices reading only its own rows."""
    lead = idx.shape[:-2]
    flat = idx.long().reshape(lead + (-1, 1))
    return torch.take_along_dim(x, flat, dim=-2).reshape(idx.shape + x.shape[-1:])


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (L..., H, *rest) at idx (L..., k) along the axis after L ->
    (L..., k, *rest)."""
    d = idx.dim() - 1
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.dim() - idx.dim())), dim=d)


def pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (L..., H, *rest) at one index per problem i (L...) -> (L..., *rest)."""
    return take(x, i[..., None]).squeeze(i.dim())


def linalg_in_slices(fn: Callable, A: torch.Tensor):
    """fn (a batched factorization returning a tuple) over A (..., n, n),
    LINALG_BATCH matrices at a time."""
    lead = A.shape[:-2]
    flat = A.reshape((-1,) + A.shape[-2:])
    parts = [fn(c) for c in flat.split(LINALG_BATCH)]
    outs = parts[0] if len(parts) == 1 else tuple(torch.cat(o) for o in zip(*parts))
    return tuple(o.reshape(lead + o.shape[1:]) for o in outs)


# Live fp32 tables of (hypotheses x match slots) that one pair holds at the
# peak of a pose search, and the bytes a batch of pairs may hold at once.
_TABLES_PER_PAIR = 12
_BATCH_BYTES = {"cuda": 8 << 30, "cpu": 1 << 30}


def pair_slices(n_pairs: int, n_hypotheses: int, n_slots: int, device) -> list:
    """Slices of the pair axis small enough for the memory budget: all pairs
    at once where they fit. The budget is fixed per device type, so the
    slices, and the shapes the polish's CUDA graphs are kept for, depend on
    the data alone."""
    budget = _BATCH_BYTES["cuda" if torch.device(device).type == "cuda" else "cpu"]
    step = max(1, budget // (_TABLES_PER_PAIR * n_hypotheses * max(n_slots, 1) * 4))
    return [slice(a, min(a + step, n_pairs)) for a in range(0, n_pairs, step)]


def ransac(
    key: Optional[torch.Tensor],
    fit: Callable[[torch.Tensor], torch.Tensor],
    residuals: Callable[[torch.Tensor], torch.Tensor],
    valid: torch.Tensor,
    n_hypotheses: int,
    sample_size: int,
    threshold: float | torch.Tensor,
    samples: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-budget MSAC over a batch of problems.

    valid: (..., M), key (..., 2) (None with injected `samples`). fit(idx (..., H, s)) -> models (..., H, ...);
    residuals(models) -> (..., H, M) nonnegative residuals. Returns
    (best_model (..., ...), inlier_mask (..., M), inlier_count (...)) with
    inliers = residual < threshold among valid entries; ties keep the lower
    hypothesis.
    """
    idx = (
        samples if samples is not None
        else sample_indices(key, valid, n_hypotheses, sample_size)
    )
    models = fit(idx)
    res = residuals(models)
    res = torch.where(valid[..., None, :], res, torch.zeros_like(res))
    scores = fixed_sum(torch.clamp(res, max=threshold))
    best = torch.argmin(scores, dim=-1)
    mask = (pick(res, best) < threshold) & valid
    return pick(models, best), mask, torch.sum(mask, dim=-1)
