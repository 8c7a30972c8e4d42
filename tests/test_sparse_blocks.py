"""Sparse sub-blocks: scipy.sparse matrices as blocks in every constructor.

Parity: the reference accepts any AbstractMatrix block including
SparseMatrixCSC, and ``_nnz`` special-cases it to the stored entry count
(/root/reference/src/abstractblockmatrix.jl:65-71) while mul! dispatches to
sparse gemv transparently.  Here sparse blocks densify into the buckets
(compute is dense-tile based) but keep the reference's logical-nnz rule.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp
import scipy.sparse as sp

import blocksparse as bst


def _mixed_blocks(seed=0, n=200):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((12, 16))
    csr = sp.random(20, 10, density=0.15, format="csr", random_state=3,
                    dtype=np.float64)
    csc = sp.random(8, 24, density=0.3, format="csc", random_state=4,
                    dtype=np.float64)
    blocks = [dense, csr, csc]
    rows = [np.arange(0, 12), np.arange(40, 60), np.arange(100, 108)]
    cols = [np.arange(10, 26), np.arange(80, 90), np.arange(150, 174)]
    return blocks, rows, cols, (n, n)


def test_nnz_reference_rule():
    blocks, rows, cols, shape = _mixed_blocks()
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    expect = 12 * 16 + blocks[1].nnz + blocks[2].nnz
    assert A.nnz == expect
    # adjoint/transpose preserve nnz (parity: test_blockmatrix.jl:84-91)
    assert A.T.op.nnz == A.nnz


def test_product_matches_densified_oracle():
    blocks, rows, cols, shape = _mixed_blocks()
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    dense = np.zeros(shape)
    for b, r, c in zip(blocks, rows, cols):
        arr = b.toarray() if hasattr(b, "toarray") else np.asarray(b)
        dense[np.ix_(r, c)] += arr
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape[1])
    y = np.asarray(A @ jnp.asarray(x))
    assert np.abs(y - dense @ x).max() < 1e-13
    # round-trip: block() returns the densified values
    assert np.abs(A.block(1) - blocks[1].toarray()).max() == 0.0


def test_symmetric_and_vbcrs_accept_sparse():
    rng = np.random.default_rng(7)
    n = 96
    g1, g2 = np.arange(0, 32), np.arange(32, 96)
    d1 = sp.random(32, 32, density=0.2, format="csr", random_state=1,
                   dtype=np.float64)
    d2 = rng.standard_normal((64, 64))
    o = sp.random(32, 64, density=0.2, format="csr", random_state=2,
                  dtype=np.float64)
    S = bst.SymmetricBlockMatrix([d1, d2], [g1, g2], [o], [g1], [g2], (n, n))
    assert S.nnz == d1.nnz + 64 * 64 + 2 * o.nnz  # off-diag counts twice
    dense = np.zeros((n, n))
    dense[np.ix_(g1, g1)] += d1.toarray()
    dense[np.ix_(g2, g2)] += d2
    dense[np.ix_(g1, g2)] += o.toarray()
    dense[np.ix_(g2, g1)] += o.toarray().T
    x = rng.standard_normal(n)
    assert np.abs(np.asarray(S @ jnp.asarray(x)) - dense @ x).max() < 1e-13

    B = sp.random(32, 64, density=0.25, format="csr", random_state=9,
                  dtype=np.float64)
    V = bst.VariableBlockCompressedRowStorage([B], [0], [32], (n, n))
    # VBCRS counts dense extents (reference rule, vbcrs.jl:290-296)
    assert V.nnz == 32 * 64
    xv = rng.standard_normal(n)
    dv = np.zeros((n, n))
    dv[0:32, 32:96] = B.toarray()
    assert np.abs(np.asarray(V @ jnp.asarray(xv)) - dv @ xv).max() < 1e-13
