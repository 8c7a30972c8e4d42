"""Operator-algebra tests (the LinearMaps-equivalence layer)."""

import jax.numpy as jnp
import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def build(seed=21, shape=(200, 200), dtype=np.complex128):
    blocks, rows, cols, shp = random_block_sparse(
        seed, shape=shape, nblocks=20, max_block=30, dtype=dtype
    )
    return bst.BlockSparseMatrix(blocks, rows, cols, shp)


def test_scaled_sum_composed(rng):
    A, B = build(21), build(22)
    Sa, Sb = bst.to_scipy(A).toarray(), bst.to_scipy(B).toarray()
    x = rng.standard_normal(200) + 1j * rng.standard_normal(200)

    assert relerr((2.5 * A) @ x, 2.5 * (Sa @ x)) < TOL
    assert relerr((A * 1j) @ x, 1j * (Sa @ x)) < TOL
    assert relerr((A + B) @ x, (Sa + Sb) @ x) < TOL
    assert relerr((A - B) @ x, (Sa - Sb) @ x) < TOL
    assert relerr((-A) @ x, -(Sa @ x)) < TOL
    assert relerr((A @ B) @ x, Sa @ (Sb @ x)) < TOL
    assert relerr((A @ B).T @ x, (Sa @ Sb).T @ x) < TOL
    assert relerr((A @ B).H @ x, (Sa @ Sb).conj().T @ x) < TOL
    assert relerr((2.0 * A).H @ x, 2.0 * Sa.conj().T @ x) < TOL
    assert relerr((1j * A).H @ x, (1j * Sa).conj().T @ x) < TOL


def test_wrapper_involutions():
    A = build()
    assert A.T.T is A
    assert A.H.H is A
    assert A.conj().conj() is A
    assert isinstance(A.T.H, bst.ConjOperator)
    assert A.T.shape == (A.shape[1], A.shape[0])


def test_axpby_beta_zero_strict(rng):
    """Static beta == 0 overwrites y -- no NaN propagation (strict BLAS;
    documented divergence from blockmatrix.jl:231)."""
    A = build(dtype=np.float64)
    S = bst.to_scipy(A)
    x = rng.standard_normal(200)
    y = np.full(200, np.nan)
    out = A.axpby(x, y, 2.0, 0)
    assert not np.any(np.isnan(np.asarray(out)))
    assert relerr(out, 2.0 * (S @ x)) < TOL


def test_shape_errors():
    A = build()
    with pytest.raises(ValueError):
        A.mv(np.ones((200, 2)))
    with pytest.raises(ValueError):
        A.mm(np.ones(200))
    B = build(23, shape=(100, 100))
    with pytest.raises(ValueError):
        A + B
    with pytest.raises(ValueError):
        A @ B


def test_solver_integration(rng):
    """Operators plug into jax.scipy.sparse.linalg (LinearMap's raison d'etre)."""
    import jax.scipy.sparse.linalg as spla

    n = 120
    blocks, rows, cols, shp = random_block_sparse(
        31, shape=(n, n), nblocks=10, max_block=20, dtype=np.float64
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shp)
    # make it SPD-ish: M = A A^T + 10 I
    op = A @ A.T
    b = rng.standard_normal(n)
    matvec = lambda v: op @ v + 10.0 * v
    x, _ = spla.cg(matvec, b, tol=1e-12, maxiter=500)
    assert relerr(matvec(x), b) < 1e-8


def test_todense_matches_oracle():
    A = build()
    assert relerr(A.todense(), bst.to_scipy(A).toarray()) < TOL
