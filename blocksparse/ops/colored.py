"""Colored execution plan: coloring turns scatter-add into dense gathers.

The reference's graph coloring exists to make concurrent CPU threads
race-free: blocks within one color share no output rows, so each color is a
round of conflict-free parallel BLAS calls (blockmatrix.jl:232-243,
coloring.jl:40-43).  XLA's scatter-add needs no colors for correctness, so
a literal translation would leave the colors decorative.  The array-program
payoff of the same invariant is different:

    within a color the map (output row -> contribution) is INJECTIVE,

so the scatter-add of a color round can be re-expressed as its inverse -- a
dense GATHER ``y += contrib[src_table]`` with a host-built int32 table --
which needs no atomics.  Whether it beats the GPU's atomic scatter-add is
not measured on the H200.

Under ``schedule="colored"`` the element-granularity engine therefore runs
one gather per color instead of one scatter-add per bucket; under
``schedule="serial"`` (one color containing every block, parity
blockmatrix.jl:91-92) the injectivity argument fails and the engine keeps
the scatter-add.  The schedule choice now selects genuinely different
compiled programs -- and a *wrong* coloring produces wrong results on this
plan (two conflicting blocks in one color overwrite each other's table
slot), which is exactly the property the reference's 1-vs-5-thread CI check
probes (tests/test_colored.py::test_broken_coloring_detected).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["build_colored_plan", "colored_mode", "colored_wins"]


def colored_mode() -> str:
    import os

    return os.environ.get("BST_COLORED", "auto")


def colored_wins(ncolors: int, out_len: int, n_entries: int) -> bool:
    """Cost model: ncolors dense gathers of out_len rows vs one random
    scatter-add of n_entries indices.

    By pigeonhole ncolors >= max collision depth >= n_entries/out_len, i.e.
    ncolors*out_len >= n_entries ALWAYS -- the plan can never do *fewer*
    index operations, it can only swap scatters for cheaper gathers, which
    confines any gain to conflict-DENSE populations (many blocks
    accumulating into a small output range, the assembly/overlap-summing
    case).  GAIN is the break-even ratio of gathered rows to scattered
    indices, overridable per deployment (BST_COLORED_GAIN).  Its default
    1.5 was tuned on the chip the library was first built for and is not
    measured on the H200."""
    import os

    gain = float(os.environ.get("BST_COLORED_GAIN", "1.5"))
    return ncolors * (out_len + 1) <= gain * max(n_entries, 1)


@lru_cache(maxsize=64)
def _plan_cached(layout, colors, out_len: int, transpose: bool,
                 bucket_sel: tuple[int, ...], symmetric: bool):
    """Host-side gather tables for the element buckets ``bucket_sel`` of
    ``layout`` (cache key: layout content digest + colors + roles).

    Returns (tables, total) where ``tables`` is one int32 [out_len] array
    per color mapping output row -> position in the flattened concatenation
    of the selected buckets' contributions (sentinel = ``total`` -> reads an
    appended zero), or None when any selected block is missing from
    ``colors`` (defensive; colors partition all blocks by construction).

    ``symmetric``: plan for the fused one-read pass -- every block emits a
    forward contribution (targets = row indices) AND a mirror contribution
    (targets = col indices); the flat layout is all forward parts in bucket
    order followed by all mirror parts.  ``colors`` must then be the
    union-conflict sets (``SymmetricBlockMatrix.fusedcolors()``, SURVEY.md
    §7 stance 4) so both target sets are jointly injective per color.
    """
    buckets = [layout.buckets[i] for i in bucket_sel]
    fwd_offsets, off = [], 0
    loc = {}
    for bi, hb in enumerate(buckets):
        fwd_offsets.append(off)
        for j, g in enumerate(hb.block_ids):
            loc[int(g)] = (bi, j)
        off += hb.nblocks * (hb.mp if symmetric or not transpose else hb.kp)
    mir_offsets = []
    if symmetric:
        for hb in buckets:
            mir_offsets.append(off)
            off += hb.nblocks * hb.kp
    total = off

    def place(src, tgt, base):
        valid = tgt < out_len  # drop sentinel-padded lanes
        src[tgt[valid]] = (base + np.nonzero(valid)[0]).astype(np.int32)

    tables = []
    seen = 0
    for color in colors:
        src = np.full(out_len, total, dtype=np.int32)
        touched = False
        for g in color:
            ent = loc.get(int(g))
            if ent is None:
                continue  # block lives in a chunked bucket
            bi, j = ent
            hb = buckets[bi]
            if symmetric:
                place(src, np.asarray(hb.row_idx)[j],
                      fwd_offsets[bi] + j * hb.mp)
                place(src, np.asarray(hb.col_idx)[j],
                      mir_offsets[bi] + j * hb.kp)
            else:
                tgt = np.asarray(hb.col_idx if transpose else hb.row_idx)[j]
                s_extent = hb.kp if transpose else hb.mp
                place(src, tgt, fwd_offsets[bi] + j * s_extent)
            touched = True
            seen += 1
        if touched:
            tables.append(src)
    if seen < len(loc):
        return None  # some element block is uncolored: plan incomplete
    return tuple(tables), total


def build_colored_plan(layout, colors, out_len: int, transpose: bool,
                       bucket_sel, symmetric: bool = False):
    """Device-ready colored gather plan or None (see ``_plan_cached``).

    Only the HOST tables are cached (``_plan_cached``): this function runs
    during jit tracing (all operator applications go through the formats'
    jitted apply), so the ``jnp.asarray`` below creates compile-time
    constants -- caching the converted arrays here would store tracers in
    the lru cache and leak them into later traces.
    """
    import jax.numpy as jnp

    plan = _plan_cached(layout, colors, out_len, bool(transpose),
                        tuple(int(i) for i in bucket_sel), bool(symmetric))
    if plan is None:
        return None
    tables, total = plan
    return tuple(jnp.asarray(t) for t in tables), total
