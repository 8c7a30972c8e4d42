"""Greedy graph coloring for race-free block scheduling.

Parity target: the reference's coloring subsystem (src/coloring.jl:15-61 +
GraphsColoring.jl's WorkstreamDSATUR): two blocks *conflict* iff their output
index sets intersect; conflict-free groups ("colors") can execute as rounds
of parallel work with no write races.

The XLA scatter-add path doesn't need colors for correctness, but coloring
remains first-class because:
  - the colored gather rounds (ops/colored.py) replace scatter-add by one
    dense gather per color, which is only valid when each color is
    conflict-free; colors on the *union* of row+col index sets make both
    contributions of the symmetric one-read pass conflict-free;
  - colored execution plans mirror the reference's SerialScheduler /
    DynamicScheduler semantics (src/BlockSparseMatrices.jl:12-18) and are the
    basis of the parallel-vs-serial duality tests.

A C++ native implementation lives in native/coloring.cpp (bound in
blocksparse/coloring/native.py); this module is the pure-Python
reference implementation and fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "ColorInfo",
    "conflict_adjacency",
    "dsatur_color",
    "color_blocks",
    "validate_coloring",
]


@dataclass(frozen=True)
class ColorInfo:
    """Conflict specification over per-block output index lists.

    Parity: ``ColorInfo{R}`` + ``conflicts(::ColorInfo)`` (coloring.jl:15-61):
    element ids = block ids, conflict domain = 1..max index, two blocks
    conflict iff their index lists intersect.
    """

    indexlists: tuple[np.ndarray, ...]

    @property
    def nblocks(self) -> int:
        return len(self.indexlists)

    @property
    def max_index(self) -> int:
        return max((int(ix.max()) for ix in self.indexlists if ix.size), default=-1)


def conflict_adjacency(indexlists: Sequence[np.ndarray]) -> list[set[int]]:
    """Adjacency sets of the conflict graph.

    Built by binning blocks per output index (the reference does the same via
    ``ConflictFunctor`` over the domain 1:maxconflict, coloring.jl:45-61):
    every pair of blocks sharing an output index gets an edge.
    """
    n = len(indexlists)
    adj: list[set[int]] = [set() for _ in range(n)]
    touch: dict[int, list[int]] = {}
    for b, ix in enumerate(indexlists):
        for i in np.unique(np.asarray(ix)):
            touch.setdefault(int(i), []).append(b)
    for blocks in touch.values():
        if len(blocks) > 1:
            for i, a in enumerate(blocks):
                for b in blocks[i + 1 :]:
                    adj[a].add(b)
                    adj[b].add(a)
    return adj


def dsatur_color(adj: Sequence[set[int]]) -> np.ndarray:
    """DSATUR greedy coloring: pick the vertex with the highest saturation
    (distinct neighbor colors), tie-break by degree; assign smallest free
    color.  Returns color id per vertex (0-based).

    Parity: GraphsColoring.WorkstreamDSATUR is the reference's chosen
    algorithm (src/BlockSparseMatrices.jl:10).
    """
    n = len(adj)
    colors = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return colors
    sat: list[set[int]] = [set() for _ in range(n)]
    degree = np.array([len(a) for a in adj], dtype=np.int64)
    for _ in range(n):
        # argmax over (saturation, degree) among uncolored
        best, best_key = -1, (-1, -1)
        for v in range(n):
            if colors[v] >= 0:
                continue
            key = (len(sat[v]), int(degree[v]))
            if key > best_key:
                best, best_key = v, key
        used = sat[best]
        c = 0
        while c in used:
            c += 1
        colors[best] = c
        for u in adj[best]:
            if colors[u] < 0:
                sat[u].add(c)
    return colors


def color_blocks(indexlists: Sequence[np.ndarray], *, use_native: bool = True):
    """Group block ids into conflict-free colors.

    Returns a tuple of int32 arrays; blocks within one color share no output
    index (parity: ``colors(A)`` rounds, blockmatrix.jl:177-198).
    """
    indexlists = [np.asarray(ix).ravel() for ix in indexlists]
    if use_native:
        try:
            from . import native

            assignment = native.dsatur_color_native(indexlists)
        except Exception:
            assignment = dsatur_color(conflict_adjacency(indexlists))
    else:
        assignment = dsatur_color(conflict_adjacency(indexlists))
    ncolors = int(assignment.max()) + 1 if assignment.size else 0
    return tuple(
        np.nonzero(assignment == c)[0].astype(np.int32) for c in range(ncolors)
    )


def validate_coloring(
    indexlists: Sequence[np.ndarray], colors: Sequence[np.ndarray]
) -> bool:
    """Check colors are a partition and each color is conflict-free."""
    seen: set[int] = set()
    for group in colors:
        used: set[int] = set()
        for b in group:
            b = int(b)
            if b in seen:
                return False
            seen.add(b)
            ids = set(int(i) for i in np.asarray(indexlists[b]).ravel())
            if used & ids:
                return False
            used |= ids
    return len(seen) == len(indexlists)
