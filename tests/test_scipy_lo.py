"""scipy.sparse.linalg.LinearOperator adapter (the reference's LinearMaps
subtyping analog, abstractblockmatrix.jl:1-20)."""

import numpy as np

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse, random_symmetric

TOL = 1e-10


def test_linear_operator_roundtrip():
    blocks, rows, cols, shape = random_block_sparse(
        3, shape=(300, 260), nblocks=25, dtype=np.float64)
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    L = bst.as_linear_operator(A)
    S = bst.to_scipy(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape[1])
    y = rng.standard_normal(shape[0])
    assert np.abs(L.matvec(x) - S @ x).max() < TOL
    assert np.abs(L.rmatvec(y) - S.conj().T @ y).max() < TOL
    X = rng.standard_normal((shape[1], 3))
    assert np.abs(L.matmat(X) - S @ X).max() < TOL


def test_linear_operator_in_scipy_solver():
    from scipy.sparse.linalg import gmres

    d, di, o, ri, ci, shape = random_symmetric(
        5, n=220, ngroups=8, noffdiag=10, dtype=np.float64, contiguous=True)
    # diagonally dominate for convergence
    d = [b + np.eye(b.shape[0]) * 50 for b in d]
    Sy = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    L = bst.as_linear_operator(Sy)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(shape[0])
    x, info = gmres(L, b, rtol=1e-10, maxiter=500)
    assert info == 0
    assert np.abs(np.asarray(Sy @ x) - b).max() < 1e-6
