"""Symmetric block-sparse format: off-diagonal blocks stored once.

Parity target: ``SymmetricBlockMatrix`` (src/symmetricblockmatrix.jl:33-44,
94-126): diagonal blocks at ``diagonalindices`` stored once, off-diagonal
blocks stored once but applied *twice* -- as-is to ``y[rowindices]`` and
transposed to ``y[colindices]`` -- so the implied matrix is

    S = D + O + O^T        (O = off-diagonal blocks at (rows, cols))

The reference's 3-pass kernel (symmetricblockmatrix.jl:386-435) reads each
off-diagonal block twice; the one-read pass here reads it once and issues
both contractions.  This class always computes all three color
sets at construction regardless of the schedule -- deliberate parity with the
reference's asymmetry vs BlockSparseMatrix (symmetricblockmatrix.jl:104-110).

Transpose/adjoint semantics (derived, matching the reference's wrapper
machinery symmetricblockmatrix.jl:219-237, 307-325, 341-365):
    S^T      = D^T + O + O^T            (only the diagonal pass transposes)
    S^H      = D^H + conj(O) + O^H      (= conj-mode of the off-diag pair)
    conj(S)  = conj(D) + conj(O) + conj(O)^T
so the off-diagonal pair honors only the conj flag, while the diagonal pass
honors both flags.  Complex-symmetric (BEM/EFIE) matrices therefore get
``S' != S`` correct, which the reference tests exercise with ComplexF64
(test_symmetricblockmatrix.jl:68-98).
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
from ..ops.dispatch import apply_symmetric, check_backend

__all__ = ["SymmetricBlockMatrix"]


def _colors_tuple(colors) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(int(b) for b in group) for group in colors)


@jax.tree_util.register_pytree_node_class
class SymmetricBlockMatrix(LinearOperator):
    """Symmetric block-sparse matrix (format 2)."""

    def __init__(
        self,
        diagonals: Sequence[np.ndarray] | None = None,
        diagonalindices: Sequence[np.ndarray] | None = None,
        offdiagonals: Sequence[np.ndarray] | None = None,
        rowindices: Sequence[np.ndarray] | None = None,
        colindices: Sequence[np.ndarray] | None = None,
        shape: tuple[int, int] | None = None,
        *,
        schedule: str = sched.COLORED,
        granularity="pow2",
        backend: str = "auto",
        precision: str | None = "highest",
        dtype=None,
        _internal=None,
    ):
        if _internal is not None:
            (self._dlayout, self._olayout, self._schedule, self._backend,
             self._precision, self._granularity, self._dcolors, self._ocolors,
             self._tocolors, self._fused_colors,
             self._dbuckets, self._obuckets) = _internal
            return
        if shape is None:
            raise ValueError("shape=(nrows, ncols) is required")
        if shape[0] != shape[1]:
            raise ValueError(f"symmetric matrix must be square, got {shape}")
        self._schedule = sched.normalize_schedule(schedule)
        self._backend = check_backend(backend)
        self._precision = precision
        self._granularity = granularity
        self._dlayout = build_layout(
            diagonals, diagonalindices, diagonalindices, shape,
            granularity=granularity, dtype=dtype,
        )
        self._olayout = build_layout(
            offdiagonals, rowindices, colindices, shape,
            granularity=granularity, dtype=dtype,
        )
        self._dbuckets = stage_buckets(self._dlayout.buckets)
        self._obuckets = stage_buckets(self._olayout.buckets)

        # Always color (parity: symmetricblockmatrix.jl:104-110).
        from .. import coloring

        self._dcolors = _colors_tuple(
            coloring.color_blocks(self._dlayout.rowindices)
        )
        self._ocolors = _colors_tuple(
            coloring.color_blocks(self._olayout.rowindices)
        )
        self._tocolors = _colors_tuple(
            coloring.color_blocks(self._olayout.colindices)
        )
        # Colors on the UNION of row+col index sets: make the fused
        # one-read/two-scatter kernel conflict-free (SURVEY.md §7 stance 4).
        union_lists = [
            np.concatenate([r, c])
            for r, c in zip(self._olayout.rowindices, self._olayout.colindices)
        ]
        self._fused_colors = _colors_tuple(coloring.color_blocks(union_lists))

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        leaves = (self._dbuckets, self._obuckets)
        aux = (
            self._dlayout, self._olayout, self._schedule, self._backend,
            self._precision, self._granularity, self._dcolors, self._ocolors,
            self._tocolors, self._fused_colors,
        )
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        dbuckets, obuckets = leaves
        return cls(_internal=aux + (tuple(dbuckets), tuple(obuckets)))

    # -- properties ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return (self._dlayout.nrows, self._dlayout.ncols)

    @property
    def dtype(self):
        for bs in (self._dbuckets, self._obuckets):
            if bs:
                return bs[0][0].dtype
        return jnp.float32

    @property
    def schedule(self) -> str:
        return self._schedule

    @property
    def ndiagonals(self) -> int:
        return self._dlayout.nblocks

    @property
    def noffdiagonals(self) -> int:
        return self._olayout.nblocks

    @property
    def nnz(self) -> int:
        """Off-diagonals count twice (parity: symmetricblockmatrix.jl:367-384)."""
        return self._dlayout.nnz + 2 * self._olayout.nnz

    # -- reference API parity ----------------------------------------------
    def diagonal(self, i: int) -> np.ndarray:
        # host-side copy: no device fetch (see BlockSparseMatrix.block)
        return self._dlayout.extract_block(i)

    def offdiagonal(self, i: int) -> np.ndarray:
        # host-side copy: no device fetch (see BlockSparseMatrix.block)
        return self._olayout.extract_block(i)

    def diagonalindices(self, i: int) -> np.ndarray:
        """Parity: ``diagonalindices`` (symmetricblockmatrix.jl:327-339)."""
        return self._dlayout.rowindices[i]

    def blockrowindices(self, i: int) -> np.ndarray:
        return self._olayout.rowindices[i]

    def blockcolindices(self, i: int) -> np.ndarray:
        return self._olayout.colindices[i]

    def diagonalcolors(self):
        return self._dcolors

    def offdiagonalcolors(self):
        return self._ocolors

    def transposeoffdiagonalcolors(self):
        return self._tocolors

    def fusedcolors(self):
        """Colors on the union of row+col index sets (fused-kernel rounds)."""
        return self._fused_colors

    # -- compute ------------------------------------------------------------
    def _apply(self, x, transpose: bool, conj: bool):
        # Off-diagonal pair honors only conj; diagonal honors both flags
        # (see module docstring).
        return apply_symmetric(
            self._dbuckets, self._dlayout, self._obuckets, self._olayout,
            self.shape[0], x, transpose=transpose, conj=conj,
            precision=self._precision,
            # colored schedule -> scatter-free gather rounds: the diagonal
            # pass uses diagonalcolors, the fused one-read off-diagonal pass
            # uses fusedcolors (union row+col conflicts -- the invariant
            # both of its scatters need; SURVEY.md §7 stance 4)
            diag_colors=(
                None if sched.isserial(self._schedule) else self._dcolors
            ),
            fused_colors=(
                None if sched.isserial(self._schedule)
                else self._fused_colors
            ),
        )

    def __repr__(self):
        m, n = self.shape
        return (
            f"SymmetricBlockMatrix({m}x{n}, {self.ndiagonals} diagonal + "
            f"{self.noffdiagonals} off-diagonal blocks, nnz={self.nnz}, "
            f"dtype={self.dtype}, schedule={self._schedule!r})"
        )
