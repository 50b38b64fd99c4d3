"""Pair-block-sharded descriptor matching over a device list.

Port of sfm_danpipeline_tpu/parallel/matching.py. The all-pairs matching
loop (src/Sfm.cpp:509-583) is O(N^2) in the image count and embarrassingly
parallel: the pair list is padded to a multiple of the device count and cut
into contiguous blocks, each device matches its block against the
replicated descriptor set (`ops.matching.match_all_pairs`, which on a card
launches the hand-written knn2 kernel), and the blocks are gathered back on
`devices[0]` with the padding pairs stripped. No collective is needed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from sfm_danpipeline_torch.ba.sharded import default_devices
from sfm_danpipeline_torch.ops.matching import PairMatches, match_all_pairs


def match_all_pairs_sharded(
    descriptors: torch.Tensor,
    valid: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    ratio: float = 0.8,
    max_matches: int = 1024,
    strict_ratio: float | None = None,
    xy: torch.Tensor | None = None,
    dup_radius: float = 0.0,
    dedup: bool = True,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> PairMatches:
    """Sharded form of ops.matching.match_all_pairs over `devices` (default:
    every local card; a list may repeat one device). descriptors (N, K, D),
    valid (N, K) and xy (N, K, 2) are replicated to every device; pair_i /
    pair_j (P,) are cut into equal blocks. Returns the PairMatches of the P
    pairs on `devices[0]`, equal to the unsharded call's."""
    devs = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n = len(devs)
    P = pair_i.shape[0]
    pad = (-P) % n
    if pad:
        pair_i = torch.cat([pair_i, pair_i.new_zeros(pad)])
        pair_j = torch.cat([pair_j, pair_j.new_zeros(pad)])
    if xy is None:
        xy = torch.zeros(descriptors.shape[:2] + (2,), dtype=torch.float32, device=descriptors.device)
        dup_radius = 0.0
    per = (P + pad) // n
    blocks = [
        match_all_pairs(
            descriptors.to(d), valid.to(d), pair_i[k * per:(k + 1) * per].to(d),
            pair_j[k * per:(k + 1) * per].to(d), ratio=ratio, max_matches=max_matches,
            strict_ratio=strict_ratio, xy=xy.to(d), dup_radius=dup_radius, dedup=dedup,
        )
        for k, d in enumerate(devs)
    ]
    home = devs[0]
    return PairMatches(
        *(
            torch.cat([getattr(b, f).to(home) for b in blocks])[:P]
            for f in ("idx_a", "idx_b", "dist", "lowe", "valid")
        )
    )
