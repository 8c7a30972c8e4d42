"""Scatter-strategy duality: atomic scatter-add vs sorted segment-sum."""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sorted_matches_atomic(dtype, rng):
    blocks, rows, cols, shape = random_block_sparse(
        91, shape=(400, 400), nblocks=30, max_block=40, dtype=dtype
    )
    a = bst.BlockSparseMatrix(blocks, rows, cols, shape, scatter="atomic")
    s = bst.BlockSparseMatrix(blocks, rows, cols, shape, scatter="sorted")
    S = bst.to_scipy(a)
    x = rng.standard_normal(400)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(400)
    assert relerr(s @ x, S @ x) < TOL
    assert relerr(s.T @ x, S.T @ x) < TOL
    assert relerr(s.H @ x, S.conj().T @ x) < TOL
    assert relerr(s @ x, a @ x) < TOL
    X = np.stack([x, 2 * x], axis=1)
    assert relerr(s @ X, a @ X) < TOL


def test_sorted_with_overlapping_blocks(rng):
    b1 = rng.standard_normal((3, 3))
    b2 = rng.standard_normal((3, 3))
    rows = [np.array([0, 2, 4]), np.array([2, 3, 4])]
    cols = [np.array([1, 2, 3]), np.array([1, 3, 5])]
    A = bst.BlockSparseMatrix([b1, b2], rows, cols, (6, 6), scatter="sorted")
    S = bst.to_scipy(A)
    x = rng.standard_normal(6)
    assert relerr(A @ x, S @ x) < TOL
