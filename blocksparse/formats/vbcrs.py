"""VBCRS: variable-block compressed row storage (CSR-of-blocks).

Parity target: ``VariableBlockCompressedRowStorage`` (src/vbcrs.jl:36-122):
blocks occupy *contiguous* row/column ranges described only by a starting
index (the block's shape implies the extent); blocks are sorted by
(row, col) and grouped into block rows via ``rowptr``.  Converters from the
other two formats mirror vbcrs.jl:150-199 (the symmetric conversion expands
diagonal blocks once and off-diagonal blocks twice -- as-is and transposed).

Notes:
  - contiguous ranges take the chunk-granular engine: gathers and
    scatter-adds move C-row chunks of x and y instead of single elements
    (core/layout.py);
  - the reference leaves transposed VBCRS products serial (vbcrs.jl:303-329,
    TODO at :124); here the transpose path is the same deterministic
    scatter-add engine as the forward path, fully parallel.
  - unlike the reference ("no sanity checks are performed"), construction
    validates contiguity unless ``check=False``.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import schedule as sched
from ..core.device import stage_buckets
from ..core.layout import BlockLayout, build_layout, is_contiguous
from ..core.operator import LinearOperator
from ..ops.dispatch import apply_operand, check_backend

__all__ = ["VariableBlockCompressedRowStorage"]


def _as_start(idx, blocklen: int, axis: str, i: int, check: bool) -> int:
    """Accept either a scalar start index or a full contiguous index list."""
    a = np.asarray(idx)
    if a.ndim == 0:
        return int(a)
    a = a.ravel()
    if check:
        if not is_contiguous(a):
            raise ValueError(
                f"block {i}: {axis} indices must be a contiguous range for VBCRS"
            )
        if a.size != blocklen:
            raise ValueError(
                f"block {i}: {axis} index list length {a.size} != block extent {blocklen}"
            )
    return int(a[0]) if a.size else 0


@jax.tree_util.register_pytree_node_class
class VariableBlockCompressedRowStorage(LinearOperator):
    """CSR-of-blocks with variable block sizes and contiguous ranges (format 3)."""

    def __init__(
        self,
        blocks: Sequence[np.ndarray] | None = None,
        rowindices: Sequence | None = None,
        colindices: Sequence | None = None,
        shape: tuple[int, int] | None = None,
        *,
        schedule: str = sched.SERIAL,
        granularity="pow2",
        backend: str = "auto",
        precision: str | None = "highest",
        scatter: str = "atomic",
        dtype=None,
        check: bool = True,
        _internal=None,
    ):
        if _internal is not None:
            (self._layout, self._schedule, self._backend, self._precision,
             self._scatter, self._granularity, self._rowptr, self._row_starts,
             self._col_starts, self._blockrow_starts,
             self._buckets) = _internal
            return
        if shape is None:
            raise ValueError("shape=(nrows, ncols) is required")
        self._schedule = sched.normalize_schedule(schedule)
        self._backend = check_backend(backend)
        self._precision = precision
        self._scatter = scatter
        self._granularity = granularity

        n = len(blocks)
        # scipy.sparse blocks densify (reference parity: any AbstractMatrix
        # block; VBCRS nnz counts dense extents anyway, vbcrs.jl:290-296)
        blocks = [np.asarray(b.toarray()) if hasattr(b, "toarray")
                  else np.asarray(b) for b in blocks]
        rstarts = np.array(
            [_as_start(rowindices[i], blocks[i].shape[0], "row", i, check) for i in range(n)],
            dtype=np.int64,
        )
        cstarts = np.array(
            [_as_start(colindices[i], blocks[i].shape[1], "col", i, check) for i in range(n)],
            dtype=np.int64,
        )

        # Sort blocks by (row, col) and build rowptr in one pass
        # (parity: vbcrs.jl:78-122).
        perm = np.lexsort((cstarts, rstarts))
        blocks = [blocks[i] for i in perm]
        rstarts = rstarts[perm]
        cstarts = cstarts[perm]

        rowptr = [0]
        blockrow_starts = []
        prev = None
        for i in range(n):
            if prev is None or rstarts[i] != prev:
                if prev is not None:
                    rowptr.append(i)
                blockrow_starts.append(int(rstarts[i]))
                prev = rstarts[i]
        rowptr.append(n)
        self._rowptr = tuple(rowptr)
        self._blockrow_starts = tuple(blockrow_starts)
        self._row_starts = tuple(int(v) for v in rstarts)
        self._col_starts = tuple(int(v) for v in cstarts)

        rlists = [np.arange(rstarts[i], rstarts[i] + blocks[i].shape[0]) for i in range(n)]
        clists = [np.arange(cstarts[i], cstarts[i] + blocks[i].shape[1]) for i in range(n)]
        self._layout = build_layout(
            blocks, rlists, clists, shape, granularity=granularity, dtype=dtype
        )
        self._buckets = stage_buckets(self._layout.buckets)

    # -- converters (parity: vbcrs.jl:150-199) ------------------------------
    @classmethod
    def from_block_sparse(cls, bsm, *, schedule=None, granularity="pow2"):
        """Convert a BlockSparseMatrix (blocks must have contiguous ranges)."""
        n = bsm.nblocks
        blocks = [bsm.block(i) for i in range(n)]
        rows = [bsm.blockrowindices(i) for i in range(n)]
        cols = [bsm.blockcolindices(i) for i in range(n)]
        return cls(
            blocks, rows, cols, bsm.shape,
            schedule=schedule if schedule is not None else bsm.schedule,
            granularity=granularity,
        )

    @classmethod
    def from_symmetric(cls, sbm, *, schedule=None, granularity="pow2"):
        """Expand a SymmetricBlockMatrix: diagonals once, off-diagonals twice
        (as-is and transposed), parity with vbcrs.jl:189-199."""
        blocks, rows, cols = [], [], []
        for i in range(sbm.ndiagonals):
            blocks.append(sbm.diagonal(i))
            rows.append(sbm.diagonalindices(i))
            cols.append(sbm.diagonalindices(i))
        for i in range(sbm.noffdiagonals):
            o = sbm.offdiagonal(i)
            r = sbm.blockrowindices(i)
            c = sbm.blockcolindices(i)
            blocks.append(o)
            rows.append(r)
            cols.append(c)
            blocks.append(o.T)
            rows.append(c)
            cols.append(r)
        return cls(
            blocks, rows, cols, sbm.shape,
            schedule=schedule if schedule is not None else sbm.schedule,
            granularity=granularity,
        )

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        aux = (
            self._layout, self._schedule, self._backend, self._precision,
            self._scatter, self._granularity, self._rowptr, self._row_starts,
            self._col_starts, self._blockrow_starts,
        )
        return self._buckets, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(_internal=aux + (tuple(leaves),))

    # -- properties ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return (self._layout.nrows, self._layout.ncols)

    @property
    def dtype(self):
        if self._buckets:
            return self._buckets[0][0].dtype
        return jnp.float32

    @property
    def layout(self) -> BlockLayout:
        return self._layout

    @property
    def schedule(self) -> str:
        return self._schedule

    @property
    def nblocks(self) -> int:
        return self._layout.nblocks

    @property
    def nblockrows(self) -> int:
        return len(self._rowptr) - 1

    @property
    def rowptr(self) -> tuple[int, ...]:
        return self._rowptr

    @property
    def nnz(self) -> int:
        """Dense extents of all blocks (parity: vbcrs.jl:290-296)."""
        return self._layout.nnz

    # -- reference API parity ----------------------------------------------
    def eachblockindex(self):
        return range(self.nblocks)

    def block(self, i: int) -> np.ndarray:
        # host-side copy: no device fetch (see BlockSparseMatrix.block)
        return self._layout.extract_block(i)

    def blockrowindices(self, i: int) -> np.ndarray:
        return self._layout.rowindices[i]

    def blockcolindices(self, i: int) -> np.ndarray:
        return self._layout.colindices[i]

    def row_start(self, i: int) -> int:
        return self._row_starts[i]

    def col_start(self, i: int) -> int:
        return self._col_starts[i]

    # -- compute ------------------------------------------------------------
    def _apply(self, x, transpose: bool, conj: bool):
        out_len = self.shape[1] if transpose else self.shape[0]
        return apply_operand(
            self._buckets, self._layout, out_len, x,
            transpose=transpose, conj=conj, precision=self._precision,
            scatter=self._scatter,
        )

    def __repr__(self):
        m, n = self.shape
        return (
            f"VariableBlockCompressedRowStorage({m}x{n}, {self.nblocks} blocks in "
            f"{self.nblockrows} block rows, nnz={self.nnz}, dtype={self.dtype}, "
            f"schedule={self._schedule!r})"
        )
