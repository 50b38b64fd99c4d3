"""Run-to-run repeatable reductions.

`index_add_` and `scatter_add_` accumulate with atomics on CUDA, so their
float sums change in the last bits from run to run. The reference's runs are
bitwise repeatable, and a checkpointed run can only be checked against an
uninterrupted one if the port's are too. These forms fix the order of every
sum: the same inputs give the same bits on repeated runs on one device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    """Where each segment's rows lie: `rows` (n, longest) indexes the summed
    tensor's rows, `live` (n, longest) marks the entries that are not padding."""

    rows: torch.Tensor
    live: torch.Tensor


def segment_plan(seg: torch.Tensor, n: int) -> SegmentPlan:
    """The gather table of a sum by segment, for segment ids `seg` in [0, n):
    a stable sort groups each segment's rows in their original order, padded
    to the longest segment. Costs one device->host read (that length); a
    caller that sums several tensors over one `seg`, or the same `seg` again
    and again, makes the plan once."""
    seg_sorted, order = torch.sort(seg, stable=True)
    ids = torch.arange(n, device=seg.device, dtype=seg.dtype)
    start = torch.searchsorted(seg_sorted, ids)
    count = torch.searchsorted(seg_sorted, ids, right=True) - start
    longest = int(count.max()) if seg.numel() else 0
    slot = torch.arange(longest, device=seg.device)
    idx = torch.clamp(start[:, None] + slot[None, :], max=max(seg.numel() - 1, 0))
    return SegmentPlan(rows=order[idx], live=slot[None, :] < count[:, None])


def planned_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """out[s] = sum of x[i] over segment s of `plan`: the rows are gathered
    into an (n, longest segment) table padded with zeros and summed along it,
    a reduction whose order depends only on the shapes."""
    rows = x[plan.rows]  # (n, longest, ...)
    live = plan.live.reshape(plan.live.shape + (1,) * (x.dim() - 1))
    return torch.sum(torch.where(live, rows, torch.zeros_like(rows)), dim=1)


def binned_sum(values: torch.Tensor, bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """out[..., b] = sum over the last dim of values where bins == b: a
    histogram along the last dim as a masked dense sum (no atomics).
    values, bins: (..., S) -> (..., n_bins). Memory is S * n_bins per row;
    callers chunk the leading dims when that is large."""
    ids = torch.arange(n_bins, device=bins.device)
    hit = bins[..., :, None] == ids  # (..., S, n_bins)
    return torch.sum(torch.where(hit, values[..., :, None], torch.zeros_like(values[..., :, None])), dim=-2)


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim as a pairwise tree of elementwise adds (zero
    padded to a power of two): (..., S) -> (...). Each row's bits depend
    only on that row, not on how many rows are summed at once. A library
    reduction picks its order from the whole shape, so a batch of pairs and
    a batch of one would round one pair's sum differently."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]
