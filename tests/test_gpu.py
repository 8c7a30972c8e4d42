"""On-card test tier: the engines against the scipy oracle on a GPU.

The CPU suite checks the engines' logic; this tier checks what only the card
can: native complex and float64 products with the values staged on the
card, and that float32 products at precision="highest" do not fall to TF32.

Run on the card by ``python chip_smoke.py`` (phase 5); every test here skips
on a host without a GPU (``gpu`` fixture, tests/conftest.py).
"""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import (
    random_block_sparse,
    random_symmetric,
    random_vbcrs,
)

pytestmark = pytest.mark.gpu

TOL32 = 1e-5


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    dt = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) \
        else np.float64
    a, b = a.astype(dt), b.astype(dt)
    return float(np.max(np.abs(a - b))) / max(1e-30, float(np.max(np.abs(b))))


def _general(contiguous):
    blocks, rows, cols, shape = random_block_sparse(
        5, shape=(2000, 1800), nblocks=120, max_block=96, dtype=np.float32,
        contiguous=contiguous)
    return bst.BlockSparseMatrix(blocks, rows, cols, shape)


def _vbcrs():
    blocks, rs, cs, shape = random_vbcrs(
        6, shape=(2048, 2048), nrowgroups=20, ncolgroups=20,
        dtype=np.float32)
    return bst.VariableBlockCompressedRowStorage(blocks, rs, cs, shape)


def _symmetric(dtype=np.float32):
    d, di, o, ri, ci, shape = random_symmetric(
        3, n=2048, ngroups=24, noffdiag=60, dtype=dtype)
    return bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)


BUILDERS = {
    "general-contiguous": lambda: _general(True),
    "general-scattered": lambda: _general(False),
    "vbcrs": _vbcrs,
    "symmetric": _symmetric,
}


def test_complex_native_on_card(gpu):
    """Complex values live on the card and products run natively."""
    A = _symmetric(np.complex64)
    assert A._obuckets[0][0].devices().pop().platform == "gpu"
    S = bst.to_scipy(A).astype(np.complex128)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(A.shape[1])
         + 1j * rng.standard_normal(A.shape[1])).astype(np.complex64)
    assert relerr(A @ x, S @ x) < TOL32
    assert relerr(A.H @ x, S.conj().T @ x) < TOL32
    assert relerr(A.T @ x, S.T @ x) < TOL32


def test_float64_on_card(gpu):
    blocks, rows, cols, shape = random_block_sparse(
        9, shape=(1500, 1500), nblocks=80, max_block=64, dtype=np.complex128,
        contiguous=False)
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    S = bst.to_scipy(A)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((1500, 16)) + 1j * rng.standard_normal((1500, 16))
    assert relerr(A @ X, S @ X) < 1e-12


@pytest.mark.parametrize("fmt", sorted(BUILDERS))
def test_highest_precision_is_ieee(gpu, fmt):
    """float32 at precision="highest" stays far inside TF32's ~1e-3 error,
    on every engine: chunked, the one-hot chain, element, symmetric."""
    A = BUILDERS[fmt]()
    S = bst.to_scipy(A).astype(np.float64)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((A.shape[1], 64)).astype(np.float32)
    assert relerr(A @ X, S @ X) < TOL32
    Y = rng.standard_normal((A.shape[0], 64)).astype(np.float32)
    assert relerr(A.T @ Y, S.T @ Y) < TOL32


def test_batched_on_card(gpu):
    ops = [_general(True) for _ in range(2)]
    rng = np.random.default_rng(6)
    Xs = rng.standard_normal((2, ops[0].shape[1], 16)).astype(np.float32)
    out = np.asarray(bst.batched_mm(ops, Xs))
    for p, op in enumerate(ops):
        assert relerr(out[p], np.asarray(op @ Xs[p])) < TOL32
