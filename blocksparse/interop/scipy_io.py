"""Sparse-matrix interop: COO triplets and scipy conversion.

Parity target: src/sparse.jl -- ``rowcolvals(A)`` emits COO triplets per
format (the symmetric version emits off-diagonals, transposed off-diagonals,
then diagonals, sparse.jl:42-91) and ``sparse(A)`` assembles them; duplicate
(i, j) entries are *summed*, matching ``mul!`` accumulation of overlapping
blocks.  Here the assembly target is ``scipy.sparse`` (the oracle used by the
test suite, mirroring the reference's SparseMatrixCSC oracle pattern,
test/test_blockmatrix.jl:33-82).
"""

from __future__ import annotations

import numpy as np

from ..core.operator import (
    AdjointOperator,
    ConjOperator,
    LinearOperator,
    ScaledOperator,
    TransposeOperator,
)
from ..formats.block_sparse import BlockSparseMatrix
from ..formats.symmetric import SymmetricBlockMatrix
from ..formats.vbcrs import VariableBlockCompressedRowStorage

__all__ = ["rowcolvals", "to_scipy", "sparse", "from_scipy_blocks",
           "from_dense", "as_linear_operator"]


def _block_triplets(rows, cols, vals):
    """All (i, j, v) triplets of one dense block at (rows x cols)."""
    r = np.repeat(np.asarray(rows), len(cols))
    c = np.tile(np.asarray(cols), len(rows))
    return r, c, np.asarray(vals).ravel()


def rowcolvals(A: LinearOperator):
    """COO triplets (rows, cols, vals) of a block operator.

    Parity: ``rowcolvals`` (sparse.jl:17-123).  Wrapper operators
    (transpose/adjoint/conj/scaled) are resolved by transforming the base
    triplets, mirroring the reference's wrapper methods.
    """
    if isinstance(A, TransposeOperator):
        r, c, v = rowcolvals(A.op)
        return c, r, v
    if isinstance(A, AdjointOperator):
        r, c, v = rowcolvals(A.op)
        return c, r, np.conj(v)
    if isinstance(A, ConjOperator):
        r, c, v = rowcolvals(A.op)
        return r, c, np.conj(v)
    if isinstance(A, ScaledOperator):
        r, c, v = rowcolvals(A.op)
        return r, c, np.asarray(A.alpha) * v

    rs, cs, vs = [], [], []

    def push(rows, cols, vals):
        r, c, v = _block_triplets(rows, cols, vals)
        rs.append(r)
        cs.append(c)
        vs.append(v)

    if isinstance(A, SymmetricBlockMatrix):
        # Order parity with sparse.jl:42-91: off-diag, transposed off-diag, diag.
        for i in range(A.noffdiagonals):
            o = A.offdiagonal(i)
            push(A.blockrowindices(i), A.blockcolindices(i), o)
        for i in range(A.noffdiagonals):
            o = A.offdiagonal(i)
            push(A.blockcolindices(i), A.blockrowindices(i), o.T)
        for i in range(A.ndiagonals):
            push(A.diagonalindices(i), A.diagonalindices(i), A.diagonal(i))
    elif isinstance(A, (BlockSparseMatrix, VariableBlockCompressedRowStorage)):
        for i in range(A.nblocks):
            push(A.blockrowindices(i), A.blockcolindices(i), A.block(i))
    else:
        raise TypeError(f"rowcolvals: unsupported operator type {type(A).__name__}")

    if not rs:
        return (
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int64),
            np.zeros(0),
        )
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)


def to_scipy(A: LinearOperator):
    """Assemble as ``scipy.sparse.csc_array`` (duplicates summed).

    Parity: ``SparseArrays.sparse(A)`` (sparse.jl:127-129).
    """
    import scipy.sparse as sp

    r, c, v = rowcolvals(A)
    m, n = A.shape
    return sp.coo_array((v, (r, c)), shape=(m, n)).tocsc()


# Julia-parity alias
sparse = to_scipy


def from_dense(
    D, block_size: int, *, tol: float = 0.0, dtype=None, **kwargs
) -> BlockSparseMatrix:
    """Tile a dense matrix into uniform ``block_size`` tiles, keeping tiles
    with any entry of magnitude > ``tol``.  Convenience constructor."""
    D = np.asarray(D)
    m, n = D.shape
    blocks, rows, cols = [], [], []
    bm, bn = _tile_shape(block_size)
    for bi in range(0, m, bm):
        for bj in range(0, n, bn):
            tile = D[bi : bi + bm, bj : bj + bn]
            if not np.any(np.abs(tile) > tol):
                continue
            blocks.append(tile if dtype is None else tile.astype(dtype))
            rows.append(np.arange(bi, min(bi + bm, m)))
            cols.append(np.arange(bj, min(bj + bn, n)))
    return BlockSparseMatrix(blocks, rows, cols, (m, n), **kwargs)


def _tile_shape(block_size) -> tuple:
    """Normalize an int or (rows, cols) pair to a tile shape."""
    if np.ndim(block_size) == 0:
        bm = bn = int(block_size)
    else:
        bm, bn = (int(b) for b in block_size)
    if bm < 1 or bn < 1:
        raise ValueError(f"block_size must be positive, got {block_size!r}")
    return bm, bn


def from_scipy_blocks(S, block_size, *, dtype=None, **kwargs) -> BlockSparseMatrix:
    """Build a BlockSparseMatrix by tiling a scipy sparse matrix into uniform
    dense blocks (nonempty tiles only).  ``block_size`` is an int or a
    ``(rows, cols)`` pair.

    Convenience constructor with no direct reference equivalent; useful for
    benchmarks and for importing general sparse operators.
    """
    import scipy.sparse as sp

    S = sp.csr_array(S)
    m, n = S.shape
    blocks, rows, cols = [], [], []
    bm, bn = _tile_shape(block_size)
    for bi in range(0, m, bm):
        for bj in range(0, n, bn):
            tile = S[bi : bi + bm, bj : bj + bn]
            if tile.nnz == 0:
                continue
            dense = np.asarray(tile.todense())
            blocks.append(dense if dtype is None else dense.astype(dtype))
            rows.append(np.arange(bi, min(bi + bm, m)))
            cols.append(np.arange(bj, min(bj + bn, n)))
    return BlockSparseMatrix(blocks, rows, cols, (m, n), **kwargs)


def as_linear_operator(A):
    """Wrap any blocksparse operator as a ``scipy.sparse.linalg
    .LinearOperator`` (matvec/rmatvec/matmat via the device engines).

    The reference gets this role for free by subtyping ``LinearMaps
    .LinearMap`` (src/abstractblockmatrix.jl:1-20) so
    every LinearMaps consumer -- host-side eigensolvers, Krylov
    packages, operator algebra -- accepts its matrices; this is the
    scipy-ecosystem analog.  Inputs arrive as numpy, run through the
    jitted device path, and return as numpy.
    """
    from scipy.sparse.linalg import LinearOperator as _ScipyLO

    import jax.numpy as jnp

    dt = np.dtype(A.dtype)

    def _dev(v):
        return jnp.asarray(np.ascontiguousarray(v))

    # np.array (not asarray): device arrays view as read-only numpy, and
    # scipy's iterative solvers write into matvec results in place
    return _ScipyLO(
        shape=tuple(A.shape),
        dtype=dt,
        matvec=lambda v: np.array(A @ _dev(v.reshape(-1))),
        rmatvec=lambda v: np.array(A.H @ _dev(v.reshape(-1))),
        matmat=lambda V: np.array(A @ _dev(V)),
        rmatmat=lambda V: np.array(A.H @ _dev(V)),
    )
