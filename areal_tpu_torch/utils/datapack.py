"""Balanced partitioning / bin-packing for microbatching: the port's copy of
``areal_tpu/utils/datapack.py`` (``ffd_allocate``, ``balanced_greedy_partition``),
pure Python (the JAX package's optional native path is not carried over).
Functions take integer sizes and return index groups."""

from __future__ import annotations

import heapq
from typing import Sequence


def ffd_allocate(
    sizes: Sequence[int],
    capacity: int,
    min_groups: int = 1,
) -> list[list[int]]:
    """First-fit-decreasing bin packing into the fewest bins (>= ``min_groups``)
    whose totals stay <= ``capacity``. Raises if one item exceeds
    ``capacity``. Bins come back sorted by their first item index."""
    for i, sz in enumerate(sizes):
        if sz > capacity:
            raise ValueError(
                f"item {i} has size {sz} > microbatch capacity {capacity}; "
                "raise max_tokens_per_mb or truncate the sequence"
            )
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    bins: list[list[int]] = [[] for _ in range(min_groups)]
    loads = [0] * min_groups
    for i in order:
        sz = sizes[i]
        placed = False
        for b in range(len(bins)):
            if loads[b] + sz <= capacity or not bins[b]:
                bins[b].append(i)
                loads[b] += sz
                placed = True
                break
        if not placed:
            bins.append([i])
            loads.append(sz)
    bins = [sorted(b) for b in bins if b or len(bins) <= min_groups]
    # keep empty bins only to honor min_groups
    while len(bins) < min_groups:
        bins.append([])
    return sorted(bins, key=lambda b: (b[0] if b else len(sizes)))


def balanced_greedy_partition(sizes: Sequence[int], k: int) -> list[list[int]]:
    """Greedy longest-processing-time partition into exactly ``k`` groups:
    sort descending, always assign to the least-loaded group. Returns k
    index lists (some empty if len(sizes) < k), each sorted ascending."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    heap = [(0, g) for g in range(k)]
    heapq.heapify(heap)
    groups: list[list[int]] = [[] for _ in range(k)]
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        load, g = heapq.heappop(heap)
        groups[g].append(i)
        heapq.heappush(heap, (load + sizes[i], g))
    return [sorted(g) for g in groups]
