"""Block-row partitioning + halo planning for multi-chip execution.

The reference has no distributed backend (its only parallelism is in-process
threading, SURVEY.md §2); the scaling strategy here (BASELINE.json
north star) is **1-D block-row partitioning**: each of S shards owns a
contiguous range of output rows and every block whose first row index falls
in that range.  x is sharded by the matching (128-aligned) column partition.

Round-2 upgrade (VERDICT #4): instead of all-gathering the whole x, a
**halo plan** is computed at construction: the 128-element chunks each
shard's boundary-crossing blocks actually touch are exchanged with neighbor
``ppermute``s -- one round per ring distance d that has any traffic, each
round moving only max-over-shards(needed chunks).  Exchanged bytes scale
with the block structure's shard overlap, not with N.

The same plan serves both dataflow directions:

- **forward** (gather): owners send the needed x chunks; each shard gathers
  from ``[x_local ++ halo ++ 0]``.
- **reverse** (scatter-reduce): shards accumulate contributions for rows
  they do not own into the halo region of ``[y_local ++ halo ++ drop]``
  and ``ppermute`` the region back to the owners, who add it in.

One position table per index space therefore drives everything: ``rowtab``
(positions in the row space) is the scatter target for ``y = A x`` and the
gather source for ``y = A^T x``; ``coltab`` vice versa.  This works because
padded value rows/cols are **zero**: a table entry whose values are zero may
alias any slot (it contributes +0), so gather and scatter can share one
table with one sentinel convention.

The stacking produces *uniform* per-shard arrays -- every shard gets the
same static shapes (max-padded with zero-value slots) -- so one
``shard_map`` body serves all shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "RowPartition", "partition_rows", "HaloPlan", "plan_halo",
    "collect_reads", "stack_operand",
]

G = 128  # halo granule (elements); also the partition alignment granule


@dataclass(frozen=True)
class RowPartition:
    """Row ownership: shard s owns rows [offsets[s], offsets[s+1])."""

    nshards: int
    nrows: int
    offsets: tuple[int, ...]  # length nshards + 1

    def owner_of_row(self, r: int) -> int:
        return int(np.searchsorted(np.asarray(self.offsets), r, side="right") - 1)

    @property
    def shard_rows(self) -> int:
        sizes = {self.offsets[i + 1] - self.offsets[i] for i in range(self.nshards)}
        assert len(sizes) == 1, "non-uniform partition"
        return int(next(iter(sizes)))


def partition_rows(nrows: int, nshards: int, granule: int = G) -> RowPartition:
    """Uniform contiguous partition, shard size rounded up to ``granule`` so
    every chunk size C (C divides 128) stays aligned to shard boundaries."""
    per = -(-(-(-nrows // nshards)) // granule) * granule
    offsets = tuple(i * per for i in range(nshards + 1))
    return RowPartition(nshards=nshards, nrows=nrows, offsets=offsets)


@dataclass(frozen=True)
class HaloPlan:
    """Static neighbor-exchange schedule over one 128-aligned partition.

    For each active ring distance d, shard s exchanges with shard
    (s+d) % S: ``send_idx[d]`` is a [S, E_d] table of *local* G-chunk ids,
    zero-padded; padded slots send (forward) or receive-into (reverse)
    chunk 0 with all-zero payload, which is harmless.  Each shard's halo
    buffer is the concatenation over active distances of the E_d chunks it
    exchanges; ``chunk_pos[s]`` maps a global G-chunk id to its position in
    that buffer (G-chunk units).
    """

    S: int
    per: int                        # elements per shard in this partition
    dists: tuple[int, ...]          # active ring distances
    send_idx: tuple[np.ndarray, ...]  # per distance: [S, E_d] int32 local ids
    halo_chunks: int                # H = sum(E_d): halo G-chunks per shard
    chunk_pos: tuple[dict, ...]     # per shard: {global G-chunk -> position}

    @property
    def exchanged_bytes_per_call(self) -> int:
        """Bytes moved by the halo per SpMV (r=1, f32), summed over shards."""
        return sum(int(si.shape[1]) for si in self.send_idx) * G * 4 * self.S

    def elem_pos(self, shard: int, e: int) -> int:
        """Position of global element ``e`` in shard's [local ++ halo]."""
        c, o = divmod(int(e), G)
        lo = shard * (self.per // G)
        if lo <= c < lo + self.per // G:
            return int(e) - shard * self.per
        return (self.per // G + self.chunk_pos[shard][c]) * G + o

    def chunk_pos_c(self, shard: int, cc: int, C: int) -> int:
        """Position of global C-chunk ``cc`` in [local ++ halo], C units."""
        g = int(cc) * C // G
        lo = shard * (self.per // G)
        if lo <= g < lo + self.per // G:
            return int(cc) - shard * self.per // C
        pos_g = self.per // G + self.chunk_pos[shard][g]
        return pos_g * (G // C) + (int(cc) - g * (G // C))


def plan_halo(needed_by_shard, S: int, per: int) -> HaloPlan:
    """``needed_by_shard``: per shard, the set of global G-chunks it touches
    outside its own range.  Returns a HaloPlan (dists may be empty)."""
    cpg = per // G
    sends = {d: [[] for _ in range(S)] for d in range(1, S)}
    for s in range(S):
        for c in sorted(needed_by_shard[s]):
            if int(c) >= S * cpg:
                continue  # beyond the padded extent: zero payload anyway
            owner = min(int(c) // cpg, S - 1)
            if owner == s:
                continue
            d = (s - owner) % S
            sends[d][owner].append(int(c))
    dists = tuple(d for d in range(1, S) if any(sends[d]))
    send_idx = []
    chunk_pos = [dict() for _ in range(S)]
    offset = 0
    for d in dists:
        E = max(len(sends[d][src]) for src in range(S))
        tab = np.zeros((S, E), np.int32)
        for src in range(S):
            lst = sends[d][src]
            tab[src, : len(lst)] = [c - src * cpg for c in lst]
            dst = (src + d) % S
            for j, c in enumerate(lst):
                chunk_pos[dst][c] = offset + j
        send_idx.append(tab)
        offset += E
    return HaloPlan(S=S, per=per, dists=dists, send_idx=tuple(send_idx),
                    halo_chunks=offset, chunk_pos=tuple(chunk_pos))


def collect_reads(layout, part: RowPartition, rows_per: int, cols_per: int,
                  side: str):
    """Per shard, the set of global G-chunks of one index space ("rows" or
    "cols") that the shard's blocks touch outside its own range.

    The same chunk set covers both directions: for ``side="cols"`` these are
    the x chunks gathered in the forward product AND the y chunks scattered
    in the transpose product (VERDICT #4/#6: one plan, two uses)."""
    S = part.nshards
    use_rows = side == "rows"
    per = rows_per if use_rows else cols_per
    needed = [set() for _ in range(S)]
    for b in layout.buckets:
        C = int(b.chunk)
        for j in range(b.nblocks):
            s = _owner(b, j, layout, rows_per, S)
            lo, hi = s * per, (s + 1) * per
            if C > 1:
                idx = b.row_chunk_idx[j] if use_rows else b.col_chunk_idx[j]
                start = int(b.row_start[j] if use_rows else b.col_start[j])
                ext = b.mp if use_rows else b.kp
                if lo <= start and start + ext <= hi:
                    continue
                for cc in np.unique(idx.astype(np.int64) * C // G):
                    if not (lo // G <= cc < hi // G):
                        needed[s].add(int(cc))
            else:
                lim = layout.nrows if use_rows else layout.ncols
                ci = (b.row_idx[j] if use_rows else b.col_idx[j]).astype(np.int64)
                ci = ci[ci < lim]
                out = ci[(ci < lo) | (ci >= hi)]
                for cc in np.unique(out // G):
                    needed[s].add(int(cc))
    return needed


def _owner(b, j, layout, rows_per: int, S: int) -> int:
    """Owning shard of bucket b's block j (by first real row index)."""
    mp = b.mp
    first = int(b.row_idx[j, int(b.row_off[j])]) if mp else 0
    if first >= layout.nrows:
        first = int(b.row_idx[j, 0])
    return min(first // rows_per, S - 1)


def stack_operand(layout, part: RowPartition, cols_per: int,
                  row_halo: HaloPlan, col_halo: HaloPlan):
    """Stack one operand's buckets into uniform per-shard arrays.

    Blocks are split by locality: "loc" blocks touch only their owner's row
    AND col ranges (they run before any halo traffic lands, giving XLA the
    compute to overlap the ``ppermute``s with); "rem" blocks address the
    halo regions.  Each group carries:

      values [S, nbmax, mp, kp]
      rowtab [S, nbmax, mp(/C)]  positions in [rows_per ++ Hr*G ++ 1]
      coltab [S, nbmax, kp(/C)]  positions in [cols_per ++ Hc*G ++ 1]

    ``rowtab`` scatters y (forward) and gathers x (transpose/mirror);
    ``coltab`` gathers x (forward) and scatters y (transpose/mirror).  The
    trailing sentinel slot absorbs padding (zero values, so any aliasing is
    +0; the slot only keeps tables in range for chunk reshapes).

    Returns a list over buckets of {"loc": {...}, "rem": {...}}.
    """
    S = part.nshards
    rows_per = part.shard_rows
    Lr = rows_per + row_halo.halo_chunks * G
    Lc = cols_per + col_halo.halo_chunks * G
    out = []
    for b in layout.buckets:
        nb = b.nblocks
        mp, kp = b.mp, b.kp
        C = int(b.chunk)
        chunked = C > 1 and cols_per % C == 0 and rows_per % C == 0
        owner = np.empty(nb, dtype=np.int64)
        local = np.zeros(nb, dtype=bool)
        for j in range(nb):
            s = _owner(b, j, layout, rows_per, S)
            owner[j] = s
            rlo, rhi = s * rows_per, (s + 1) * rows_per
            clo, chi = s * cols_per, (s + 1) * cols_per
            if chunked:
                rs, cs = int(b.row_start[j]), int(b.col_start[j])
                local[j] = (rlo <= rs and rs + mp <= rhi
                            and clo <= cs and cs + kp <= chi)
            else:
                ri = b.row_idx[j].astype(np.int64)
                ri = ri[ri < layout.nrows]
                ci = b.col_idx[j].astype(np.int64)
                ci = ci[ci < layout.ncols]
                local[j] = bool(
                    np.all((ri >= rlo) & (ri < rhi))
                    and np.all((ci >= clo) & (ci < chi))
                )

        groups = {}
        for key, members in (("loc", local), ("rem", ~local)):
            ids = np.nonzero(members)[0]
            counts = (np.bincount(owner[ids], minlength=S) if ids.size
                      else np.zeros(S, int))
            nbmax = int(counts.max()) if ids.size else 0
            values = np.zeros((S, nbmax, mp, kp), dtype=b.values.dtype)
            fill = np.zeros(S, dtype=np.int64)
            if chunked:
                rowtab = np.full((S, nbmax, mp // C), Lr // C, np.int32)
                coltab = np.full((S, nbmax, kp // C), Lc // C, np.int32)
            else:
                rowtab = np.full((S, nbmax, mp), Lr, np.int32)
                coltab = np.full((S, nbmax, kp), Lc, np.int32)
            for j in ids:
                s = int(owner[j])
                slot = int(fill[s])
                fill[s] += 1
                values[s, slot] = b.values[j]
                if chunked:
                    rowtab[s, slot] = [
                        Lr // C if int(cc) * C >= S * rows_per
                        else row_halo.chunk_pos_c(s, cc, C)
                        for cc in b.row_chunk_idx[j]
                    ]
                    coltab[s, slot] = [
                        Lc // C if int(cc) * C >= S * cols_per
                        else col_halo.chunk_pos_c(s, cc, C)
                        for cc in b.col_chunk_idx[j]
                    ]
                else:
                    rowtab[s, slot] = [
                        Lr if e >= layout.nrows else row_halo.elem_pos(s, e)
                        for e in b.row_idx[j]
                    ]
                    coltab[s, slot] = [
                        Lc if e >= layout.ncols else col_halo.elem_pos(s, e)
                        for e in b.col_idx[j]
                    ]
            groups[key] = dict(values=values, rowtab=rowtab, coltab=coltab,
                               chunk=C if chunked else 1)
        out.append(groups)
    return out
