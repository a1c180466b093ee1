"""Deterministic heal-stripe planning — the port's copy of
``torchft_tpu/checkpointing/stripes.py``.

The striped multi-source heal treats the flattened state tree as one
logical byte stream (the header rides the control plane) and partitions
it into byte-balanced ranges served by different live peers. The unit is
a byte range of the concatenation, not a whole leaf, so the plan is
balanced to the alignment quantum even when one large leaf (an embedding
table, an optimizer moment) dominates the tree.

Both sides derive the same plan from the same inputs (total size, source
count), so no stripe coordination rides the wire: the healer puts the
concrete ``(offset, len)`` in each range request and any source can serve
any range.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from torchft_tpu_torch.checkpointing.serialization import as_bytes

__all__ = [
    "stripe_ranges",
    "slice_buffers",
    "assign_chunk_groups",
    "heal_sources_limit",
    "heal_stripes_per_source",
    "STRIPES_PER_SOURCE",
]

# range boundaries are aligned down to this quantum; the tail range takes
# the remainder
_ALIGN = 64

# Ranges per source: more ranges than sources keep the tail short and make
# re-striping after a source death cheap (only the dead source's pending
# ranges move). The JAX package reads TORCHFT_HEAL_STRIPES; nothing in the
# port sets another value, so it is a constant (a test may patch it).
STRIPES_PER_SOURCE = 2


def heal_sources_limit() -> int:
    """Most peers a healer stripes over (``TORCHFT_HEAL_SOURCES``, default
    4; 1 turns the multi-source heal and the stripe-source staging off)."""
    try:
        return max(1, int(os.environ.get("TORCHFT_HEAL_SOURCES", "4")))
    except ValueError:
        return 4


def heal_stripes_per_source() -> int:
    return STRIPES_PER_SOURCE


def stripe_ranges(total_bytes: int, n: int) -> List[Tuple[int, int]]:
    """Partition ``[0, total_bytes)`` into ``n`` contiguous byte ranges,
    balanced to within the alignment quantum (the tail takes the
    remainder). Deterministic; empty ranges are dropped, so a tiny blob
    may give fewer than ``n``."""
    if total_bytes <= 0:
        return []
    n = max(1, n)
    bounds = [((total_bytes * i // n) // _ALIGN) * _ALIGN for i in range(n)]
    bounds.append(total_bytes)
    out: List[Tuple[int, int]] = []
    for i in range(n):
        length = bounds[i + 1] - bounds[i]
        if length > 0:
            out.append((bounds[i], length))
    return out


def slice_buffers(
    buffers: Sequence[np.ndarray],
    sizes: Sequence[int],
    offset: int,
    length: int,
) -> Iterator[memoryview]:
    """The byte slices of the buffers' logical concatenation that cover
    ``[offset, offset+length)``: the HTTP side of a range request (the
    native blob server walks the same layout in C++). ``sizes[i]`` is
    ``buffers[i]``'s byte length."""
    pos = 0
    remaining = length
    for buf, size in zip(buffers, sizes):
        if remaining <= 0:
            return
        end = pos + size
        if end > offset and size > 0:
            lo = max(0, offset - pos)
            hi = min(size, offset + length - pos)
            if hi > lo:
                yield as_bytes(buf)[lo:hi]
                remaining -= hi - lo
        pos = end


def assign_chunk_groups(sizes: List[int], num_chunks: int) -> List[List[int]]:
    """Greedy size-balanced (largest first) assignment of whole-buffer
    indices to chunks: the grouping of the chunked ``/metadata`` +
    ``/chunk_i`` mode. The striped heal uses :func:`stripe_ranges`, which
    splits large leaves and balances exactly."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    totals = [0] * num_chunks
    groups: List[List[int]] = [[] for _ in range(num_chunks)]
    for i in order:
        c = totals.index(min(totals))
        groups[c].append(i)
        totals[c] += sizes[i]
    for g in groups:
        g.sort()  # each chunk streams its buffers in a fixed order
    return groups
