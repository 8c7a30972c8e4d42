"""jax.experimental.sparse (BCOO) interop round-trips.

Analog of the reference's SparseMatrixCSC conversion tests
(/root/reference/test/test_blockmatrix.jl:38-49) targeting the JAX-native
sparse type instead of scipy.
"""

import jax.numpy as jnp
import numpy as np

import blocksparse as bst
from blocksparse.utils import testmatrices as tm

TOL = 1e-13


def test_to_bcoo_matches_scipy_oracle():
    blocks, rows, cols, shape = tm.random_block_sparse(0, nblocks=40, dtype=np.float64)
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    mat = bst.to_bcoo(A)
    dense = np.asarray(mat.todense())
    oracle = np.asarray(bst.to_scipy(A).todense())
    assert dense.shape == tuple(shape)
    assert np.max(np.abs(dense - oracle)) < TOL


def test_to_bcoo_symmetric_and_wrappers():
    d, di, o, ri, ci, shape = tm.random_symmetric(1, n=400, ngroups=16, noffdiag=20)
    S = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    for op in (S, S.T, S.H):
        dense = np.asarray(bst.to_bcoo(op).todense())
        oracle = np.asarray(bst.to_scipy(op).todense())
        assert np.max(np.abs(dense - oracle)) < TOL


def test_from_bcoo_round_trip():
    from jax.experimental import sparse as jsparse

    rng = np.random.default_rng(2)
    D = np.zeros((96, 96))
    # plant a few dense tiles
    for bi, bj in [(0, 0), (32, 64), (64, 32)]:
        D[bi : bi + 32, bj : bj + 32] = rng.standard_normal((32, 32))
    mat = jsparse.BCOO.fromdense(jnp.asarray(D))
    A = bst.from_bcoo(mat, 32)
    assert np.max(np.abs(A.todense() - D)) < TOL
    x = rng.standard_normal(96)
    assert np.max(np.abs(np.asarray(A.mv(jnp.asarray(x))) - D @ x)) < 1e-12


def test_from_bcoo_rectangular_tiles():
    from jax.experimental import sparse as jsparse

    rng = np.random.default_rng(5)
    D = np.zeros((64, 96))
    D[0:16, 0:32] = rng.standard_normal((16, 32))
    D[48:64, 64:96] = rng.standard_normal((16, 32))
    mat = jsparse.BCOO.fromdense(jnp.asarray(D))
    A = bst.from_bcoo(mat, (16, 32))
    assert len(list(A.eachblockindex())) == 2
    assert np.max(np.abs(A.todense() - D)) < TOL


def test_bcoo_matvec_agrees_with_operator():
    blocks, rows, cols, shape = tm.random_block_sparse(3, nblocks=30, dtype=np.float64)
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    mat = bst.to_bcoo(A)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(shape[1]))
    assert np.max(np.abs(np.asarray(mat @ x) - np.asarray(A.mv(x)))) < 1e-10
