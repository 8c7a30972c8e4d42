"""Preconditioners over the block-sparse operator algebra.

The reference plugs into Krylov packages through the LinearMaps interface
(src/abstractblockmatrix.jl:13) and leaves preconditioning
to the caller; block matrices from BEM near-field assembly carry their
natural preconditioner *in their own structure* — the (block-)diagonal.
This module extracts it:

- :func:`jacobi`: point-Jacobi ``M^{-1} = diag(A)^{-1}`` as a
  :class:`DiagonalOperator` (an elementwise multiply under jit).
- :func:`block_jacobi`: true block-Jacobi — invert the block-diagonal part
  of the *assembled* matrix over each diagonal block's index set.  The
  result is itself a :class:`~blocksparse.formats.block_sparse.
  BlockSparseMatrix` of the small dense inverses, so applying the
  preconditioner runs through the same engines as the operator
  (plus a diagonal fallback for rows no diagonal block covers).

Both return :class:`~blocksparse.core.operator.LinearOperator`s and are
accepted directly as ``M=`` by :mod:`blocksparse.solvers` and by
``jax.scipy.sparse.linalg``.

Inversion happens once, host-side, at construction (f64 numpy regardless of
the operator dtype, then cast back) — the preconditioner setup is the
analog of the reference's coloring setup cost (docs/src/block.md:98):
pay once, amortize over Krylov iterations.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .core.operator import LinearOperator
from .formats.block_sparse import BlockSparseMatrix
from .formats.symmetric import SymmetricBlockMatrix

__all__ = ["DiagonalOperator", "jacobi", "block_jacobi"]


@jax.tree_util.register_pytree_node_class
class DiagonalOperator(LinearOperator):
    """``x -> d * x`` for a fixed diagonal vector ``d`` (jit/pytree-ready)."""

    def __init__(self, d):
        self.d = jnp.asarray(d)
        if self.d.ndim != 1:
            raise ValueError(f"diagonal must be 1-D, got ndim={self.d.ndim}")

    def tree_flatten(self):
        return (self.d,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype

    def _apply(self, x, transpose, conj):
        d = jnp.conj(self.d) if conj else self.d
        return d * x if x.ndim == 1 else d[:, None] * x

    def __repr__(self):
        n = self.d.shape[0]
        return f"DiagonalOperator({n}x{n}, dtype={self.d.dtype})"


def _assembled(A: LinearOperator):
    from .interop.scipy_io import to_scipy

    if A.shape[0] != A.shape[1]:
        raise ValueError(f"preconditioners need a square operator, got {A.shape}")
    return to_scipy(A).tocsr()


def _safe_recip(d: np.ndarray) -> np.ndarray:
    """1/d with zeros mapped to 1 (identity on structurally-empty rows)."""
    out = np.ones_like(d)
    nz = d != 0
    out[nz] = 1.0 / d[nz]
    return out


def jacobi(A: LinearOperator) -> DiagonalOperator:
    """Point-Jacobi preconditioner ``diag(A)^{-1}`` (zeros -> identity)."""
    d = _assembled(A).diagonal()
    return DiagonalOperator(jnp.asarray(_safe_recip(d).astype(A.dtype)))


def _diagonal_candidates(A: LinearOperator):
    """Index sets of the operator's own diagonal blocks.

    For :class:`SymmetricBlockMatrix` these are the stored diagonals
    (symmetricblockmatrix.jl:33-44 analog); for the general formats, blocks
    whose row and column index lists coincide.
    """
    if isinstance(A, SymmetricBlockMatrix):
        return [np.asarray(A.diagonalindices(i)) for i in range(A.ndiagonals)]
    sets = []
    for i in A.eachblockindex():
        ri, ci = np.asarray(A.blockrowindices(i)), np.asarray(A.blockcolindices(i))
        if ri.shape == ci.shape and np.array_equal(ri, ci):
            sets.append(ri)
    return sets


def block_jacobi(A: LinearOperator, *, index_sets=None, **kwargs) -> LinearOperator:
    """Block-Jacobi preconditioner from the operator's diagonal blocks.

    ``M = blockdiag(A[I_k, I_k])`` over each diagonal block's index set
    ``I_k`` (overlapping contributions from *other* blocks are included —
    the submatrices are sliced from the assembled matrix, not from the
    stored block values).  Returns ``M^{-1}`` as a
    :class:`BlockSparseMatrix` of the dense inverses; rows not covered by
    any diagonal block fall back to point-Jacobi through a
    :class:`DiagonalOperator` summand.

    ``index_sets`` overrides the automatic detection (any iterable of
    integer index arrays; overlapping sets are rejected).  Extra kwargs
    (``backend=``, ``schedule=``, ...) pass through to the
    BlockSparseMatrix constructor.
    """
    S = _assembled(A)
    n = A.shape[0]
    sets = _diagonal_candidates(A) if index_sets is None else [
        np.asarray(s, dtype=np.int64) for s in index_sets
    ]

    covered = np.zeros(n, dtype=bool)
    blocks, rows, cols = [], [], []
    for idx in sets:
        if covered[idx].any():
            if index_sets is not None:
                raise ValueError("index_sets overlap; block-Jacobi needs disjoint sets")
            continue  # auto-detected duplicate coverage: first block wins
        covered[idx] = True
        sub = np.asarray(S[np.ix_(idx, idx)].todense())
        try:
            inv = np.linalg.inv(sub)
        except np.linalg.LinAlgError:
            warnings.warn(
                f"singular {len(idx)}x{len(idx)} diagonal block; using pseudoinverse",
                stacklevel=2,
            )
            inv = np.linalg.pinv(sub)
        blocks.append(inv.astype(A.dtype))
        rows.append(idx)
        cols.append(idx)

    if not blocks:
        return jacobi(A)

    M = BlockSparseMatrix(blocks, rows, cols, (n, n), **kwargs)
    if covered.all():
        return M
    d = np.where(covered, 0.0, _safe_recip(np.asarray(S.diagonal())))
    return M + DiagonalOperator(jnp.asarray(d.astype(A.dtype)))
