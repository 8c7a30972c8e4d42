"""General block-sparse format: dense blocks at arbitrary index lists.

Parity target: ``BlockSparseMatrix`` (src/blockmatrix.jl:26-109): dense
blocks placed at arbitrary -- possibly non-contiguous, possibly overlapping --
row/column index lists inside a large (M, N) matrix.  Overlapping blocks sum,
matching the reference's ``mul!`` accumulation and its ``sparse()``
duplicate-summing conversion (src/sparse.jl:127-129).

Divergences for a compiled array program (SURVEY.md §7):
  - structure-of-arrays shape buckets with sentinel-padded index tables
    instead of ``Vector{Matrix}`` + views (core/layout.py);
  - gather / batched-einsum / scatter-add instead of per-block BLAS gemv on
    views (ops/xla_spmv.py);
  - adjoint/transpose are flag flips that swap the index tables and color
    sets (parity: blockmatrix.jl:154-206) -- zero data movement.

Schedule parity: ``schedule="serial"`` skips coloring and uses one color
containing all blocks (blockmatrix.jl:91-92); ``schedule="colored"`` computes
``colors`` (row-conflict) and ``transposecolors`` (col-conflict) at
construction via DSATUR (blockmatrix.jl:94-98).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import schedule as sched
from ..core.device import stage_buckets
from ..core.layout import BlockLayout, build_layout
from ..core.operator import LinearOperator
from ..ops.dispatch import apply_operand, check_backend

__all__ = ["BlockSparseMatrix"]


def _colors_tuple(colors) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(int(b) for b in group) for group in colors)


@jax.tree_util.register_pytree_node_class
class BlockSparseMatrix(LinearOperator):
    """General block-sparse matrix (format 1)."""

    def __init__(
        self,
        blocks: Sequence[np.ndarray] | None = None,
        rowindices: Sequence[np.ndarray] | None = None,
        colindices: Sequence[np.ndarray] | None = None,
        shape: tuple[int, int] | None = None,
        *,
        schedule: str = sched.SERIAL,
        granularity="pow2",
        backend: str = "auto",
        precision: str | None = "highest",
        scatter: str = "atomic",
        dtype=None,
        _internal=None,
    ):
        if _internal is not None:
            (self._layout, self._schedule, self._backend, self._precision,
             self._scatter, self._granularity, self._colors, self._tcolors,
             self._buckets) = _internal
            return
        if shape is None:
            raise ValueError("shape=(nrows, ncols) is required")
        self._schedule = sched.normalize_schedule(schedule)
        self._backend = check_backend(backend)
        self._precision = precision
        self._scatter = scatter
        self._granularity = granularity
        self._layout = build_layout(
            blocks, rowindices, colindices, shape,
            granularity=granularity, dtype=dtype,
        )
        self._buckets = stage_buckets(self._layout.buckets)
        if sched.isserial(self._schedule):
            # Parity: serial skips graph work -> one color with every block
            # (blockmatrix.jl:91-92).
            all_ids = tuple(range(self._layout.nblocks))
            self._colors = (all_ids,) if all_ids else ()
            self._tcolors = (all_ids,) if all_ids else ()
        else:
            from .. import coloring

            self._colors = _colors_tuple(coloring.color_blocks(self._layout.rowindices))
            self._tcolors = _colors_tuple(coloring.color_blocks(self._layout.colindices))

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        leaves = self._buckets
        aux = (self._layout, self._schedule, self._backend, self._precision,
               self._scatter, self._granularity, self._colors, self._tcolors)
        return leaves, aux

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
    def nnz(self) -> int:
        """Logical nnz: sum of unpadded block areas (blockmatrix.jl:208-223)."""
        return self._layout.nnz

    # -- reference API parity ----------------------------------------------
    def eachblockindex(self):
        """Parity: ``eachblockindex`` (blockmatrix.jl:124-134)."""
        return range(self._layout.nblocks)

    def block(self, i: int) -> np.ndarray:
        """Unpadded dense block ``i`` (parity: ``block``, blockmatrix.jl:150-160).

        Reads the host-side layout copy (construction values): no device
        fetch."""
        return self._layout.extract_block(i)

    def blockrowindices(self, i: int) -> np.ndarray:
        return self._layout.rowindices[i]

    def blockcolindices(self, i: int) -> np.ndarray:
        return self._layout.colindices[i]

    def colors(self) -> tuple[tuple[int, ...], ...]:
        """Row-conflict colors (parity: ``colors(A)``, blockmatrix.jl:177-198)."""
        return self._colors

    def transposecolors(self) -> tuple[tuple[int, ...], ...]:
        return self._tcolors

    # -- compute ------------------------------------------------------------
    def _apply(self, x, transpose: bool, conj: bool):
        out_len = self.shape[1] if transpose else self.shape[0]
        return apply_operand(
            self._buckets, self._layout, out_len, x,
            transpose=transpose, conj=conj, precision=self._precision,
            scatter=self._scatter,
            # colored schedule: the element engine may run the scatter-free
            # colored gather rounds (ops/colored.py); transpose products
            # use transposecolors (col-conflict sets), the exact role swap
            # of the reference (blockmatrix.jl:200-206)
            colors=(
                None if sched.isserial(self._schedule)
                else (self._tcolors if transpose else self._colors)
            ),
        )

    def __repr__(self):
        m, n = self.shape
        return (
            f"BlockSparseMatrix({m}x{n}, {self.nblocks} blocks, "
            f"{len(self._buckets)} buckets, nnz={self.nnz}, dtype={self.dtype}, "
            f"schedule={self._schedule!r})"
        )
