"""The CUDA graphs the port replays on the card: the two-view Sampson polish
(`ops/epipolar.py _polish`), the pair step of triangulation
(`pipeline/incremental.py triangulate_new_view_all`), and PnP's P3P Newton
loop and select-refine-accept chain (`ops/pnp.py solve_pnp_ransac`).

A chain of small ops with fixed shapes that reads nothing back to the host
costs the host one dispatch per op; captured as one graph it costs one
replay. `CapturedChain` is the graph of one such chain at one shape (the
triangulation keeps its own class: it replays once per pair and chains the
state through its buffers). Two capture rules:

- The polish and triangulation (`cached_graph`): a shape's first call runs
  eagerly (it is the warm-up: cuBLAS handles and every lazy set-up happen
  outside a capture), its second captures the graph, later calls replay
  it. Each graph holds a private memory pool, so a cache keeps only its
  last few shapes.
- PnP: once the process has run one solve eagerly, a shape captures at its
  first call. Its set-up is per process, not per shape, and a set meets
  most of its PnP shapes (one per done-view count) once, so under the
  first rule every set would dispatch them eagerly. Its graphs share one
  memory pool per device and are kept for the process: their shapes are
  bounded by the done-view count.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Optional, Sequence, TypeVar

import torch

from sfm_danpipeline_torch.utils import profiling

G = TypeVar("G")


class CapturedChain:
    """`fn(*tensors, *fills)` captured as one CUDA graph at one shape, in the
    memory pool `pool` (None: a private one). Each call copies its tensors
    into the graph's static buffers, writes its fills (Python floats or
    0-dim tensors) into 0-dim buffers with `fill_` (a value captured as a
    kernel argument would not change on replay), replays, and clones the
    outputs, which the next replay overwrites. The replay runs the eager
    chain's kernels in the same order on the same values, so its outputs
    are the eager chain's bit for bit. The counter `captures` counts the
    capture, `replays` (where given) every call. Graphs may share a pool
    where no two replays overlap, no graph reads another's buffers, and
    every call clones its outputs before the next replay."""

    def __init__(self, fn: Callable, tensors: Sequence[torch.Tensor], fill_dtypes: Sequence[torch.dtype],
                 captures: str, replays: Optional[str] = None, pool=None):
        dev = tensors[0].device
        self.replays = replays
        self.inputs = [torch.empty_like(a, memory_format=torch.contiguous_format) for a in tensors]
        self.fills = [torch.empty((), dtype=d, device=dev) for d in fill_dtypes]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = fn(*self.inputs, *self.fills)
        profiling.count(captures)

    def __call__(self, tensors: Sequence[torch.Tensor], fills=()):
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)
        for dst, value in zip(self.fills, fills):
            dst.fill_(value)
        self.graph.replay()
        if self.replays is not None:
            profiling.count(self.replays)
        return tuple(o.clone() for o in self.outputs)


def cached_graph(
    cache: "OrderedDict[Hashable, Optional[G]]", kept: int, key: Hashable, make: Callable[[], G]
) -> Optional[G]:
    """The graph `cache` holds for `key`: None at the key's first use,
    `make()` at its second, the same graph after. The most recently used
    key goes last; beyond `kept` keys the least recently used is forgotten,
    and comes back as a first use."""
    seen = key in cache
    graph = cache.pop(key, None)
    if seen and graph is None:
        graph = make()
    cache[key] = graph
    while len(cache) > kept:
        cache.popitem(last=False)
    return graph
