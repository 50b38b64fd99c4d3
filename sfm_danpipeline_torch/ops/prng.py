"""The reference's random draws, bit for bit, in plain torch integer ops.

The JAX package draws every RANSAC sample from an explicit threefry2x32 key
tree (`jax.random.key`, `split`, `fold_in`, `randint`). Threefry is a
counter-based hash: 20 rounds of 32-bit add, rotate and xor over a
(key, counter) pair. So the same key gives the same bits on any device, and
this module computes exactly what JAX computes under its default
`jax_threefry_partitionable=True`:

- `split(key, n)[i]` and `fold_in(key, i)` hash the 64-bit counter i, as the
  word pair (hi, lo) = (0, i), under `key`; the two output words are the
  new key. So a split is prefix-stable: `split(k, n)[:m] == split(k, m)`.
- `random_bits(key, shape)` hashes the flat row-major index of each element
  and returns the xor of the two output words.
- `randint(key, shape, maxval)` splits the key in two, draws a higher and a
  lower word, and folds them into [0, maxval) with uint32 wrap-around
  (`jax/_src/random.py _randint`).

A key is an int64 tensor (..., 2) holding two uint32 words; every function
takes leading batch dims on it, so many problems draw in one call. torch has
no full uint32 arithmetic on CUDA, so the words live in int64 and are masked
to 32 bits wherever a sum or a shift could carry past them. All of it is
exact integer arithmetic, so the bits are the same on the CPU and on a card:
the work runs on the device the key lies on.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words (x0, x1) under key words
    (k0, k1), elementwise with broadcasting; all int64 holding uint32.

    x0 is masked only where the key is injected: between injections it
    grows by at most one bit per round (from < 2**32 to < 2**36), which
    int64 holds, and x1 reads only its low 32 bits through the masked
    xor."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            y = x1 << r
            x1 = ((y | (y >> 32)) ^ x0) & M32
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & M32
    return x0, x1


def key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """`jax.random.key(seed)`'s data for a 32-bit seed: the words
    (0, seed mod 2**32)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range the reference accepts")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def _words(key: torch.Tensor):
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise TypeError(f"a key is an int64 tensor (..., 2), got {key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def _hash_counters(key: torch.Tensor, n: int) -> tuple:
    """Both output words of counters 0..n-1 under every key of the batch:
    two tensors (..., n)."""
    if n >= 2**32:
        raise ValueError(f"{n} counters pass the 32-bit low word")
    k0, k1 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split`: n new keys per key, (..., 2) -> (..., n, 2)."""
    return torch.stack(_hash_counters(key, n), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in` with a 32-bit `data`: (..., 2) -> (..., 2)."""
    if not 0 <= int(data) <= M32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(k0), torch.full_like(k1, int(data)))
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits` at 32 bits: (..., 2) -> (..., *shape), int64
    holding uint32."""
    shape = tuple(int(s) for s in shape)
    b0, b1 = _hash_counters(key, math.prod(shape))
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def fold_bits(hi: torch.Tensor, lo: torch.Tensor, maxval) -> torch.Tensor:
    """`randint`'s fold of a higher and a lower uint32 word into
    [0, maxval), in uint32 arithmetic with its wrap-around. `maxval` an
    int or a tensor broadcast against hi; values <= 0 give 0.

    The multiplier is (2**16 mod span)**2 mod span, its square wrapped as
    uint32 wraps it (to 0 for spans past 2**16). Every factor is below
    span < 2**31, so each product is below 2**62 and exact in int64; the
    masks reproduce uint32's wrap."""
    span = torch.as_tensor(maxval, dtype=torch.int64, device=hi.device)
    span = torch.where(span <= 0, torch.ones_like(span), span)
    if bool(torch.any(span >= 2**31)):
        raise ValueError("randint's bound must lie in the int32 range")
    mult = torch.remainder(65536, span)
    mult = torch.remainder((mult * mult) & M32, span)
    off = (torch.remainder(hi, span) * mult) & M32
    off = (off + torch.remainder(lo, span)) & M32
    return torch.remainder(off, span)


def randint_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The two words `randint` folds, drawn in one hash: (..., 2) ->
    (..., 2, *shape), the higher word at index 0."""
    return random_bits(split(key, 2), shape)


def randint(key: torch.Tensor, shape: Sequence[int], maxval) -> torch.Tensor:
    """`jax.random.randint(key, shape, 0, maxval)` (int32 dtype): (..., 2)
    -> (..., *shape) int64. `maxval` an int, or a tensor of the keys'
    leading shape (one bound per problem)."""
    shape = tuple(int(s) for s in shape)
    if int(torch.as_tensor(maxval).max()) >= 2**31:
        raise ValueError("randint's bound must lie in the int32 range")
    bits = randint_bits(key, shape)
    if torch.is_tensor(maxval):
        maxval = maxval.to(key.device).reshape(maxval.shape + (1,) * len(shape))
    hi, lo = bits.unbind(dim=-1 - len(shape))
    return fold_bits(hi, lo, maxval)
