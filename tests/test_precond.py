"""Preconditioner tests: block-Jacobi / point-Jacobi over the operator
algebra, and their effect on Krylov convergence.

The reference has no preconditioner component (solvers consume its
LinearMaps interface raw); these validate the addition against
dense-math oracles.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils import testmatrices as tm

TOL = 1e-12


def _spd_symmetric(seed=0, n=600, ngroups=24, noffdiag=24):
    """An SPD SymmetricBlockMatrix: random symmetric + dominant diagonal."""
    rng = np.random.default_rng(seed)
    d, di, o, ri, ci, shape = tm.random_symmetric(
        seed, n=n, ngroups=ngroups, noffdiag=noffdiag, dtype=np.float64
    )
    # make each diagonal block SPD-dominant: D <- D D^T + (width * ngroups) I
    d = [b @ b.T + (b.shape[0] + 50.0) * np.eye(b.shape[0]) for b in d]
    return bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape), rng


def test_diagonal_operator_algebra():
    rng = np.random.default_rng(1)
    d = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    D = bst.DiagonalOperator(jnp.asarray(d))
    x = jnp.asarray(rng.standard_normal(50) + 1j * rng.standard_normal(50))
    assert np.max(np.abs(np.asarray(D @ x) - d * np.asarray(x))) < TOL
    assert np.max(np.abs(np.asarray(D.T @ x) - d * np.asarray(x))) < TOL
    assert np.max(np.abs(np.asarray(D.H @ x) - np.conj(d) * np.asarray(x))) < TOL
    X = jnp.asarray(rng.standard_normal((50, 3)))
    assert np.max(np.abs(np.asarray(D @ X) - d[:, None] * np.asarray(X))) < TOL


def test_jacobi_matches_dense_diagonal():
    blocks, rows, cols, shape = tm.random_block_sparse(2, nblocks=40, dtype=np.float64)
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    M = bst.jacobi(A)
    dense = np.asarray(bst.to_scipy(A).todense())
    d = dense.diagonal()
    expect = np.where(d != 0, np.divide(1.0, d, where=d != 0), 1.0)
    x = np.random.default_rng(3).standard_normal(shape[0])
    assert np.max(np.abs(np.asarray(M @ jnp.asarray(x)) - expect * x)) < TOL


def test_block_jacobi_exact_on_block_diagonal_matrix():
    """On a purely block-diagonal matrix, block-Jacobi IS the inverse."""
    rng = np.random.default_rng(4)
    blocks, rows, cols = [], [], []
    start = 0
    for w in (8, 16, 12, 24):
        b = rng.standard_normal((w, w)) + w * np.eye(w)
        blocks.append(b)
        idx = np.arange(start, start + w)
        rows.append(idx)
        cols.append(idx)
        start += w
    n = start
    A = bst.BlockSparseMatrix(blocks, rows, cols, (n, n))
    M = bst.block_jacobi(A)
    assert isinstance(M, bst.BlockSparseMatrix)  # fully covered: no fallback
    x = rng.standard_normal(n)
    y = np.asarray(M @ (A @ jnp.asarray(x)))
    assert np.max(np.abs(y - x)) < 1e-9


def test_block_jacobi_includes_overlapping_contributions():
    """The block-diagonal is sliced from the ASSEMBLED matrix, so overlap
    from non-diagonal blocks lands in the preconditioner."""
    rng = np.random.default_rng(5)
    idx = np.arange(0, 10)
    diag = rng.standard_normal((10, 10)) + 20 * np.eye(10)
    # an extra block overlapping rows/cols 5..9 contributes to the diagonal block
    extra = rng.standard_normal((5, 5))
    A = bst.BlockSparseMatrix(
        [diag, extra], [idx, np.arange(5, 10)], [idx, np.arange(5, 10)], (12, 12)
    )
    M = bst.block_jacobi(A)
    dense = np.asarray(bst.to_scipy(A).todense())
    Minv = np.linalg.inv(dense[:10, :10])
    x = rng.standard_normal(12)
    got = np.asarray(M @ jnp.asarray(x))
    expect = np.concatenate([Minv @ x[:10], x[10:]])  # uncovered zero rows -> identity
    assert np.max(np.abs(got - expect)) < 1e-10


def test_block_jacobi_uncovered_rows_fall_back_to_point_jacobi():
    rng = np.random.default_rng(6)
    idx = np.arange(0, 8)
    diag = rng.standard_normal((8, 8)) + 10 * np.eye(8)
    off = rng.standard_normal((4, 4)) + 5 * np.eye(4)  # rows 8..11, NOT detected
    A = bst.BlockSparseMatrix(
        [diag, off], [idx, np.arange(8, 12)], [idx, np.arange(9, 13)], (14, 14)
    )
    M = bst.block_jacobi(A)
    dense = np.asarray(bst.to_scipy(A).todense())
    d = dense.diagonal()
    x = rng.standard_normal(14)
    got = np.asarray(M @ jnp.asarray(x))
    expect = x.copy()
    expect[:8] = np.linalg.inv(dense[:8, :8]) @ x[:8]
    for i in range(8, 14):
        expect[i] = x[i] / d[i] if d[i] != 0 else x[i]
    assert np.max(np.abs(got - expect)) < 1e-10


def test_block_jacobi_symmetric_uses_stored_diagonals():
    S, rng = _spd_symmetric()
    M = bst.block_jacobi(S)
    dense = np.asarray(bst.to_scipy(S).todense())
    x = rng.standard_normal(S.shape[0])
    got = np.asarray(M @ jnp.asarray(x))
    # oracle: exact block-diagonal inverse over the stored diagonal index sets
    expect = x.copy()
    for i in range(S.ndiagonals):
        idx = np.asarray(S.diagonalindices(i))
        expect[idx] = np.linalg.solve(dense[np.ix_(idx, idx)], x[idx])
    assert np.max(np.abs(got - expect)) < 1e-9


def test_block_jacobi_accelerates_cg():
    S, rng = _spd_symmetric(seed=7)
    b = jnp.asarray(rng.standard_normal(S.shape[0]))
    _, info_plain = bst.cg(S, b, tol=1e-10, maxiter=4000)
    M = bst.block_jacobi(S)
    x, info_pre = bst.cg(S, b, tol=1e-10, maxiter=4000, M=M)
    assert bool(info_pre.converged)
    assert int(info_pre.iterations) < int(info_plain.iterations)
    r = np.linalg.norm(np.asarray(S @ x) - np.asarray(b)) / np.linalg.norm(b)
    assert r < 1e-8


def test_block_jacobi_explicit_index_sets_and_overlap_rejection():
    rng = np.random.default_rng(8)
    dense = rng.standard_normal((16, 16)) + 16 * np.eye(16)
    A = bst.from_dense(dense, block_size=16)
    M = bst.block_jacobi(A, index_sets=[np.arange(0, 8), np.arange(8, 16)])
    x = rng.standard_normal(16)
    expect = x.copy()
    expect[:8] = np.linalg.solve(dense[:8, :8], x[:8])
    expect[8:] = np.linalg.solve(dense[8:, 8:], x[8:])
    assert np.max(np.abs(np.asarray(M @ jnp.asarray(x)) - expect)) < 1e-10
    with pytest.raises(ValueError, match="overlap"):
        bst.block_jacobi(A, index_sets=[np.arange(0, 9), np.arange(8, 16)])


def test_preconditioners_reject_rectangular():
    blocks = [np.ones((3, 4))]
    A = bst.BlockSparseMatrix(blocks, [np.arange(3)], [np.arange(4)], (6, 8))
    with pytest.raises(ValueError, match="square"):
        bst.jacobi(A)
    with pytest.raises(ValueError, match="square"):
        bst.block_jacobi(A)


def test_jacobi_fallback_when_no_diagonal_blocks():
    rng = np.random.default_rng(9)
    # strictly off-diagonal blocks only
    A = bst.BlockSparseMatrix(
        [rng.standard_normal((4, 4))], [np.arange(0, 4)], [np.arange(4, 8)], (8, 8)
    )
    M = bst.block_jacobi(A)
    assert isinstance(M, bst.DiagonalOperator)  # pure point-Jacobi fallback
    x = rng.standard_normal(8)
    assert np.max(np.abs(np.asarray(M @ jnp.asarray(x)) - x)) < TOL  # zero diag -> identity
