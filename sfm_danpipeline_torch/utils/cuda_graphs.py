"""The per-shape caches of the CUDA graphs the port replays on the card
(`ops/epipolar.py _polish`, `pipeline/incremental.py
triangulate_new_view_all`).

A chain of small ops with fixed shapes that reads nothing back to the host
costs the host one dispatch per op; captured as one graph it costs one
replay. The policy is the same for every such chain: a shape's first call
runs eagerly (it is the warm-up: cuBLAS handles and every lazy set-up
happen outside a capture), its second captures the graph, later calls
replay it. Each graph holds a private memory pool, so a cache keeps only
its last few shapes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Optional, TypeVar

G = TypeVar("G")


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
