"""All-pairs descriptor matching with Lowe ratio test.

Port of sfm_danpipeline_tpu/ops/matching.py. The top-2 nearest-neighbour
search has two implementations with the same semantics:

 - `knn2_torch`: plain PyTorch (matmul identity + masked reductions), the
   twin of the reference's `knn2_jnp`;
 - `knn2`: the wrapper of the hand-written CUDA kernel csrc/knn2.cu (the
   port of the TPU kernel `knn2_pallas`), batched over the pair list. It
   launches the kernel for CUDA tensors and takes `knn2_torch` only for
   tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from sfm_danpipeline_torch import kernels
from sfm_danpipeline_torch.ops.select import top_k_indices

_INF = 3.4e38


@dataclasses.dataclass(frozen=True)
class PairMatches:
    """Fixed-shape match set for one image pair (or a leading pair dim).

    idx_a, idx_b: (..., M) int32 keypoint indices into each image's set
    dist:         (..., M) float32 L2 descriptor distance
    lowe:         (..., M) float32 per-match Lowe ratio d1/d2
    valid:        (..., M) bool
    """

    idx_a: torch.Tensor
    idx_b: torch.Tensor
    dist: torch.Tensor
    lowe: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1)

    def at_ratio(self, ratio: float) -> "PairMatches":
        """Subset that also passes the stricter `ratio` test."""
        return dataclasses.replace(self, valid=self.valid & (self.lowe <= ratio))

    def pair(self, p: int) -> "PairMatches":
        """The matches of pair `p` of a batched set."""
        return PairMatches(*(getattr(self, f.name)[p] for f in dataclasses.fields(self)))


def knn2_torch(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    xy_b: torch.Tensor | None = None,
    dup_r2: float = -1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each row of desc_a (..., Ka, D): (best_idx, best_d2, second_d2)
    over valid rows of desc_b (..., Kb, D); leading dims batch.

    With `xy_b` (..., Kb, 2) and `dup_r2` > 0, the second-best search skips
    candidates within sqrt(dup_r2) px of the best (co-located twins from
    SIFT's secondary-orientation rows)."""
    cross = desc_a @ desc_b.transpose(-1, -2)
    na = torch.sum(desc_a * desc_a, dim=-1, keepdim=True)
    nb = torch.sum(desc_b * desc_b, dim=-1)
    d2 = torch.clamp(na + nb[..., None, :] - 2.0 * cross, min=0.0)
    d2 = torch.where(valid_b[..., None, :], d2, torch.full_like(d2, _INF))
    # argmin returns the first (lowest) index on ties, like jnp.argmin.
    best_idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    excl = cols == best_idx[..., None]
    if xy_b is not None and dup_r2 > 0:
        best_xy = torch.gather(
            xy_b, -2, best_idx[..., None].expand(*best_idx.shape, 2)
        )
        dx = xy_b[..., None, :, 0] - best_xy[..., :, None, 0]
        dy = xy_b[..., None, :, 1] - best_xy[..., :, None, 1]
        excl = excl | (dx * dx + dy * dy <= dup_r2)
    second = torch.min(
        torch.where(excl, torch.full_like(d2, _INF), d2), dim=-1
    ).values
    return best_idx.to(torch.int32), best, second


KNN2_MAX_D = 1216  # widest descriptor whose A tile fits the kernel's shared memory


def _kernel_width(d: int) -> int:
    """The descriptor width the kernel is given for `d` columns: the next
    multiple of 4 (it copies 16 bytes at a time); raises beyond KNN2_MAX_D."""
    width = -(-d // 4) * 4
    if width > KNN2_MAX_D:
        raise ValueError(
            f"knn2: descriptor width {d} exceeds the kernel's shared memory "
            f"(at most {KNN2_MAX_D})"
        )
    return width


def _launch_knn2(descriptors, valid, xy, pair_i, pair_j, dup_r2):
    """Launch csrc/knn2.cu on CUDA tensors (already validated by `knn2`)."""
    N, K, D = descriptors.shape
    width = _kernel_width(D)
    if width != D:
        # Zero columns change no distance.
        descriptors = torch.nn.functional.pad(descriptors, (0, width - D))
        D = width
    fn = kernels.load("knn2").knn2_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_void_p] * 8
    )
    P = pair_i.shape[0]
    if P * K >= 2**31:
        raise ValueError("knn2 takes fewer than 2**31 / K pairs per launch")
    dev = descriptors.device
    idx = torch.empty((P, K), dtype=torch.int32, device=dev)
    best = torch.empty((P, K), dtype=torch.float32, device=dev)
    second = torch.empty((P, K), dtype=torch.float32, device=dev)
    # Scratch: squared norms (plain, and with the sentinel for invalid rows),
    # and the rows that the exact second sweep has to finish.
    norms = torch.empty((2, N, K), dtype=torch.float32, device=dev)
    flag_count = torch.empty((1,), dtype=torch.int32, device=dev)
    flag_list = torch.empty((P, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            descriptors.data_ptr(), valid.data_ptr(), xy.data_ptr(),
            pair_i.data_ptr(), pair_j.data_ptr(), N, P, K, D, float(dup_r2),
            idx.data_ptr(), best.data_ptr(), second.data_ptr(),
            norms[0].data_ptr(), norms[1].data_ptr(), flag_count.data_ptr(),
            flag_list.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn2 kernel launch failed: cudaError {rc}")
    knn2.launches += 1
    knn2.last_flagged = flag_count
    return idx, best, second


def knn2(
    descriptors: torch.Tensor,
    valid: torch.Tensor,
    xy: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    dup_r2: float = -1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 search for every listed pair: rows of image pair_i[p] against
    image pair_j[p]. descriptors (N, K, D) f32, valid (N, K) bool, xy
    (N, K, 2) f32, pair_i / pair_j (P,) int32, all contiguous on one device.
    Returns (best_idx (P, K) int32, best_d2 (P, K), second_d2 (P, K)).

    CUDA tensors run the hand-written kernel (csrc/knn2.cu) or raise; CPU
    tensors run `knn2_torch`. `knn2.launches` counts kernel launches;
    `knn2.last_flagged` is the last launch's (1,) int32 device tensor with the
    number of rows whose second-best needed the kernel's exact second sweep."""
    if descriptors.dim() != 3 or descriptors.dtype != torch.float32:
        raise ValueError("descriptors must be (N, K, D) float32")
    N, K, D = descriptors.shape
    if valid.shape != (N, K) or valid.dtype != torch.bool:
        raise ValueError("valid must be (N, K) bool")
    if xy.shape != (N, K, 2) or xy.dtype != torch.float32:
        raise ValueError("xy must be (N, K, 2) float32")
    if (
        pair_i.dim() != 1 or pair_i.shape != pair_j.shape
        or pair_i.dtype != torch.int32 or pair_j.dtype != torch.int32
    ):
        raise ValueError("pair_i / pair_j must be matching (P,) int32")
    tensors = (descriptors, valid, xy, pair_i, pair_j)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("knn2 inputs must lie on one device")
    if pair_i.numel():
        # One device-to-host copy for both bounds.
        lo, hi = torch.stack(torch.aminmax(torch.cat([pair_i, pair_j]))).tolist()
        if lo < 0 or hi >= N:
            raise ValueError("pair index out of range")
    device = descriptors.device
    if device.type == "cpu":
        pi, pj = pair_i.long(), pair_j.long()
        return knn2_torch(
            descriptors[pi], descriptors[pj], valid[pj], xy[pj], dup_r2
        )
    if device.type != "cuda":
        raise ValueError(f"knn2 runs on cuda or cpu tensors, not {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("knn2 inputs must be contiguous")
    return _launch_knn2(descriptors, valid, xy, pair_i, pair_j, dup_r2)


knn2.launches = 0
knn2.last_flagged = None


def match_all_pairs(
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
) -> PairMatches:
    """Ratio-test matches for an explicit pair list (the reference's O(N^2)
    matching loop, batched). descriptors (N, K, D), valid (N, K), pair_i /
    pair_j (P,). Returns PairMatches with leading dim P.

    A match (i -> j) is kept when d1 <= ratio * d2 (L2 distances), i is
    valid, and 2 valid candidates exist. The best `max_matches` by distance
    fill fixed slots; `strict_ratio` ranks strict matches ahead of
    loose-only ones; `xy` with `dup_radius` > 0 skips co-located twins in
    the second-best search and, with `dedup`, keeps one correspondence per
    physical point pair."""
    dup_r2 = float(dup_radius) ** 2 if dup_radius > 0 else -1.0
    N, Kn = valid.shape
    pair_i = pair_i.to(torch.int32).contiguous()
    pair_j = pair_j.to(torch.int32).contiguous()
    xy_k = xy if xy is not None else torch.zeros(
        (N, Kn, 2), dtype=torch.float32, device=descriptors.device
    )
    best_idx, best_d2, second_d2 = knn2(
        descriptors.contiguous(), valid.contiguous(), xy_k.contiguous(),
        pair_i, pair_j, dup_r2 if xy is not None else -1.0,
    )
    pi, pj = pair_i.long(), pair_j.long()
    valid_a = valid[pi]
    d1 = torch.sqrt(best_d2)
    d2 = torch.sqrt(torch.clamp(second_d2, max=_INF))
    lowe = d1 / torch.clamp(d2, min=1e-12)
    keep = valid_a & (best_d2 < _INF) & (second_d2 < _INF) & (lowe <= ratio)
    score = torch.where(keep, -d1, torch.full_like(d1, -_INF))
    if strict_ratio is not None:
        score = torch.where(keep & (lowe > strict_ratio), score - 1e9, score)
    P, Ka = score.shape
    k = min(max_matches, Ka)
    # top_k tie order matters: every invalid slot scores -3.4e38, and the
    # -1e9 strict bias swallows d1 in f32 (see ops/select.py).
    order = top_k_indices(score, k)
    pad_mask = torch.arange(max_matches, device=score.device) < k
    if k < max_matches:
        order = torch.cat(
            [order, order.new_zeros((P, max_matches - k))], dim=-1
        )
    valid_m = torch.gather(keep, 1, order) & pad_mask
    midx_b = torch.gather(best_idx.long(), 1, order)
    if dedup and dup_r2 > 0 and xy is not None:
        axy = torch.gather(xy[pi], 1, order[..., None].expand(P, max_matches, 2))
        bxy = torch.gather(xy[pj], 1, midx_b[..., None].expand(P, max_matches, 2))
        da = axy[:, :, None, :] - axy[:, None, :, :]
        db = bxy[:, :, None, :] - bxy[:, None, :, :]
        same_a = torch.sum(da * da, dim=-1) <= dup_r2
        same_b = (midx_b[:, :, None] == midx_b[:, None, :]) | (
            torch.sum(db * db, dim=-1) <= dup_r2
        )
        ar = torch.arange(max_matches, device=score.device)
        earlier = ar[None, :] < ar[:, None]
        dup = torch.any(same_a & same_b & earlier & valid_m[:, None, :], dim=-1)
        valid_m = valid_m & ~dup
    return PairMatches(
        idx_a=order.to(torch.int32),
        idx_b=midx_b.to(torch.int32),
        dist=torch.gather(d1, 1, order),
        lowe=torch.gather(lowe, 1, order),
        valid=valid_m,
    )


def match_pair(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    ratio: float = 0.8,
    max_matches: int = 1024,
    strict_ratio: float | None = None,
    xy_a: torch.Tensor | None = None,
    xy_b: torch.Tensor | None = None,
    dup_radius: float = 0.0,
    dedup: bool = True,
) -> PairMatches:
    """Ratio-test matches from image a to image b: `match_all_pairs` on the
    one pair (a, b). The two sets are padded to a common keypoint count
    with invalid rows, which the search never selects."""
    K = max(desc_a.shape[0], desc_b.shape[0])

    def pad(t, n, fill=0):
        extra = K - n
        if extra == 0:
            return t
        return torch.cat([t, t.new_full((extra,) + t.shape[1:], fill)])

    Ka, Kb = desc_a.shape[0], desc_b.shape[0]
    desc = torch.stack([pad(desc_a, Ka), pad(desc_b, Kb)])
    valid = torch.stack([pad(valid_a, Ka, False), pad(valid_b, Kb, False)])
    xy = None
    if xy_a is not None and xy_b is not None:
        xy = torch.stack([pad(xy_a, Ka), pad(xy_b, Kb)])
    pairs = torch.tensor([0], dtype=torch.int32, device=desc.device)
    m = match_all_pairs(
        desc, valid, pairs, pairs + 1, ratio=ratio, max_matches=max_matches,
        strict_ratio=strict_ratio, xy=xy, dup_radius=dup_radius, dedup=dedup,
    ).pair(0)
    if K > Ka:
        # Padded A rows are never kept; trim their slots' indices to range.
        m = dataclasses.replace(m, idx_a=torch.clamp(m.idx_a, max=Ka - 1))
    return m
