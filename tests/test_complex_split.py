"""Split re/im complex execution vs the native complex oracle."""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse, random_symmetric

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def test_block_sparse_split(rng):
    blocks, rows, cols, shape = random_block_sparse(
        111, shape=(300, 300), nblocks=20, max_block=40, dtype=np.complex128
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    P = bst.split_complex(A)
    S = bst.to_scipy(A)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)

    assert relerr(P @ x, S @ x) < TOL
    assert relerr(P.T @ x, S.T @ x) < TOL
    assert relerr(P.H @ x, S.conj().T @ x) < TOL
    assert relerr(P.conj() @ x, S.conj() @ x) < TOL
    assert relerr(P.axpby(x, x, 1j, 2j), 1j * (S @ x) + 2j * x) < TOL

    # split API: real arrays in, real arrays out
    yr, yi = P.mv_split(x.real, x.imag)
    ref = S @ x
    assert relerr(np.asarray(yr) + 1j * np.asarray(yi), ref) < TOL

    X = rng.standard_normal((300, 4)) + 1j * rng.standard_normal((300, 4))
    Yr, Yi = P.mm_split(X.real, X.imag)
    assert relerr(np.asarray(Yr) + 1j * np.asarray(Yi), S @ X) < TOL


def test_symmetric_split(rng):
    d, di, o, ri, ci, shape = random_symmetric(
        112, n=400, ngroups=10, noffdiag=15, dtype=np.complex128
    )
    S_op = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    P = bst.split_complex(S_op)
    S = bst.to_scipy(S_op)
    x = rng.standard_normal(400) + 1j * rng.standard_normal(400)
    assert relerr(P @ x, S @ x) < TOL
    assert relerr(P.T @ x, S.T @ x) < TOL
    assert relerr(P.H @ x, S.conj().T @ x) < TOL
    assert P.schedule == S_op.schedule


def test_split_pytree_and_jit(rng):
    import jax

    blocks, rows, cols, shape = random_block_sparse(
        113, shape=(120, 120), nblocks=8, max_block=20, dtype=np.complex128
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    P = bst.split_complex(A)
    xr = rng.standard_normal(120)
    xi = rng.standard_normal(120)

    @jax.jit
    def f(op, xr, xi):
        return op.mv_split(xr, xi)

    yr, yi = f(P, xr, xi)
    S = bst.to_scipy(A)
    ref = S @ (xr + 1j * xi)
    assert relerr(np.asarray(yr) + 1j * np.asarray(yi), ref) < TOL
