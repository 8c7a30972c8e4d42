"""Dtype coverage: complex64, float32, bf16 storage through every engine."""

import jax.numpy as jnp
import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse, random_vbcrs


def relerr(a, b):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


@pytest.mark.parametrize("contiguous", [False, True])
def test_complex64(contiguous, rng):
    """BEM's on-chip dtype: c64 through element and chunked engines."""
    blocks, rows, cols, shape = random_block_sparse(
        101, shape=(300, 300), nblocks=20, max_block=40,
        dtype=np.complex64, contiguous=contiguous,
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    S = bst.to_scipy(A).astype(np.complex128)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300)).astype(
        np.complex64
    )
    assert relerr(A @ x, S @ x) < 1e-5
    assert relerr(A.H @ x, S.conj().T @ x) < 1e-5
    assert relerr(A.conj() @ x, S.conj() @ x) < 1e-5


def test_bf16_storage(rng):
    blocks, rstarts, cstarts, shape = random_vbcrs(
        102, shape=(256, 256), nrowgroups=4, ncolgroups=4, dtype=np.float64
    )
    b16 = [jnp.asarray(b, dtype=jnp.bfloat16) for b in blocks]
    V = bst.VariableBlockCompressedRowStorage(
        b16, rstarts, cstarts, shape, dtype=jnp.bfloat16
    )
    assert V.dtype == jnp.bfloat16
    Vref = bst.VariableBlockCompressedRowStorage(blocks, rstarts, cstarts, shape)
    x = rng.standard_normal(256).astype(np.float32)
    assert relerr(np.asarray(V @ x, dtype=np.float32), np.asarray(Vref @ x)) < 2e-2


def test_mixed_dtype_promotion(rng):
    blocks, rows, cols, shape = random_block_sparse(
        103, shape=(100, 100), nblocks=6, max_block=15, dtype=np.float32
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    x = rng.standard_normal(100)  # f64 vector x f32 matrix
    y = A @ x
    assert relerr(y, bst.to_scipy(A).astype(np.float64) @ x) < 1e-6
