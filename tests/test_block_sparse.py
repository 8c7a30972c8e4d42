"""Oracle tests for BlockSparseMatrix (format 1).

Mirrors the reference's test strategy (test/test_blockmatrix.jl, SURVEY.md
§4): build the block matrix, convert with ``to_scipy``, then assert products,
transposed/adjoint products, and 5-arg axpby with complex alpha/beta all
match the scipy oracle to 1e-13, for both serial and colored schedules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


FIXTURES = {
    "sphere": dict(seed=1, shape=(1203, 1203), nblocks=100, max_block=60),
    "cuboid": dict(seed=2, shape=(1344, 1344), nblocks=96, max_block=141),
}


def build(name, dtype, schedule, contiguous=False, granularity=(32, 32)):
    # granularity (32, 32) keeps the number of distinct bucket shapes (and
    # therefore XLA compile time) low; correctness under other granularities
    # is covered by test_granularity_invariance.
    cfg = FIXTURES[name]
    blocks, rows, cols, shape = random_block_sparse(
        cfg["seed"],
        shape=cfg["shape"],
        nblocks=cfg["nblocks"],
        max_block=cfg["max_block"],
        dtype=dtype,
        contiguous=contiguous,
    )
    return bst.BlockSparseMatrix(
        blocks, rows, cols, shape, schedule=schedule, granularity=granularity
    )


@pytest.mark.parametrize("name", ["sphere", "cuboid"])
@pytest.mark.parametrize(
    "dtype,schedule",
    [
        (np.float64, bst.SERIAL),
        (np.complex128, bst.SERIAL),
        (np.complex128, bst.COLORED),
    ],
)
def test_oracle_products(name, dtype, schedule, rng):
    A = build(name, dtype, schedule)
    S = bst.to_scipy(A)
    m, n = A.shape

    for _ in range(10):
        x = rng.standard_normal(n)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            x = x + 1j * rng.standard_normal(n)
        y = rng.standard_normal(m)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            y = y + 1j * rng.standard_normal(m)

        assert relerr(A @ x, S @ x) < TOL
        assert relerr(A.T @ y, S.T @ y) < TOL
        assert relerr(A.H @ y, S.conj().T @ y) < TOL
        # 5-arg mul! parity with complex alpha/beta (test_blockmatrix.jl:65-81)
        out = A.axpby(x, y, 1j, 2j)
        assert relerr(out, 1j * (S @ x) + 2j * y) < TOL
        # conj path
        assert relerr(A.conj() @ x, S.conj() @ x) < TOL


def test_todense_matches_oracle():
    """Element equality of the materialization (test_blockmatrix.jl:38-49)."""
    A = build("sphere", np.complex128, bst.SERIAL)
    assert relerr(A.todense(), bst.to_scipy(A).toarray()) < TOL


@pytest.mark.parametrize("name", ["sphere"])
def test_multi_rhs_spmm(name, rng):
    A = build(name, np.complex128, bst.SERIAL)
    S = bst.to_scipy(A)
    X = rng.standard_normal((A.shape[1], 7)) + 1j * rng.standard_normal((A.shape[1], 7))
    Y = rng.standard_normal((A.shape[0], 7)) + 1j * rng.standard_normal((A.shape[0], 7))
    assert relerr(A @ X, S @ X) < TOL
    assert relerr(A.T @ Y, S.T @ Y) < TOL
    assert relerr(A.H @ Y, S.conj().T @ Y) < TOL
    assert relerr(A.mm(X), S @ X) < TOL


def test_overlapping_blocks_sum(rng):
    """Overlapping blocks accumulate (matches scipy duplicate summing)."""
    b1 = rng.standard_normal((3, 3))
    b2 = rng.standard_normal((3, 3))
    rows = [np.array([0, 2, 4]), np.array([2, 3, 4])]
    cols = [np.array([1, 2, 3]), np.array([1, 3, 5])]
    A = bst.BlockSparseMatrix([b1, b2], rows, cols, (6, 6))
    S = bst.to_scipy(A)
    x = rng.standard_normal(6)
    assert relerr(A @ x, S @ x) < TOL
    dense = np.zeros((6, 6))
    dense[np.ix_(rows[0], cols[0])] += b1
    dense[np.ix_(rows[1], cols[1])] += b2
    assert relerr(S.toarray(), dense) < TOL


@pytest.mark.parametrize("schedule", [bst.SERIAL, bst.COLORED])
def test_nnz_invariance(schedule):
    A = build("sphere", np.complex128, schedule)
    assert bst.nnz(A) == bst.nnz(A.T) == bst.nnz(A.H)
    assert bst.nnz(A) == sum(
        A.block(i).size for i in bst.eachblockindex(A)
    )


def test_serial_vs_colored_duality(rng):
    """Parity with the reference's 1-vs-5-thread CI invariance (SURVEY §4)."""
    a = build("cuboid", np.complex128, bst.SERIAL)
    b = build("cuboid", np.complex128, bst.COLORED)
    x = rng.standard_normal(a.shape[1]) + 1j * rng.standard_normal(a.shape[1])
    assert relerr(a @ x, b @ x) < TOL
    assert len(b.colors()) >= 1
    # serial schedule: one color with every block (blockmatrix.jl:92)
    assert a.colors() == (tuple(range(a.nblocks)),)


@pytest.mark.parametrize("schedule", [bst.SERIAL, bst.COLORED])
def test_unsorted_index_lists(schedule, rng):
    """The reference's trial index lists are UNSORTED
    (test_blockmatrix.jl:33-82, SURVEY §4): block entry (i, j) binds to
    (rows[i], cols[j]) whatever the list order.  Exercises the gather/
    scatter tables and both schedules."""
    blocks, rows, cols, shape = random_block_sparse(
        31, shape=(700, 700), nblocks=40, max_block=50,
        dtype=np.complex128, sorted_indices=False,
    )
    # make sure the fixture is genuinely unsorted
    assert any(not np.all(np.diff(r) > 0) for r in rows)
    assert any(not np.all(np.diff(c) > 0) for c in cols)
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape, schedule=schedule,
                              backend="xla")
    S = bst.to_scipy(A)
    x = rng.standard_normal(shape[1]) + 1j * rng.standard_normal(shape[1])
    y = rng.standard_normal(shape[0]) + 1j * rng.standard_normal(shape[0])
    assert relerr(A @ x, S @ x) < TOL
    assert relerr(A.T @ y, S.T @ y) < TOL
    assert relerr(A.H @ y, S.conj().T @ y) < TOL


def test_wrapper_api_parity():
    A = build("sphere", np.complex128, bst.COLORED)
    i = 3
    assert np.array_equal(bst.rowindices(A.T, i), bst.colindices(A, i))
    assert np.array_equal(bst.colindices(A.H, i), bst.rowindices(A, i))
    assert np.allclose(bst.block(A.T, i), bst.block(A, i).T)
    assert np.allclose(bst.block(A.H, i), np.conj(bst.block(A, i)).T)
    assert bst.colors(A.T) == bst.transposecolors(A)
    assert bst.transposecolors(A.H) == bst.colors(A)


def test_jit_and_pytree_roundtrip(rng):
    A = build("sphere", np.float64, bst.SERIAL)
    x = rng.standard_normal(A.shape[1])

    @jax.jit
    def mv(op, v):
        return op @ v

    assert relerr(mv(A, x), A @ x) < TOL

    leaves, treedef = jax.tree_util.tree_flatten(A)
    A2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert relerr(A2 @ x, A @ x) < TOL
    # jit cache hit: same treedef hashable aux
    assert relerr(mv(A2, x), A @ x) < TOL


@pytest.mark.parametrize("granularity", [(1, 1), (8, 8), (8, 128)])
def test_granularity_invariance(granularity, rng):
    """Bucket padding must not change results (sentinel correctness)."""
    A = build("sphere", np.complex128, bst.SERIAL, granularity=granularity)
    S = bst.to_scipy(A)
    x = rng.standard_normal(A.shape[1]) + 1j * rng.standard_normal(A.shape[1])
    assert relerr(A @ x, S @ x) < TOL
    assert relerr(A.T @ x, S.T @ x) < TOL
    assert A.nnz == bst.nnz(A)  # logical nnz unaffected by padding


def test_display_smoke(capsys):
    """Parity: @test_nowarn println(A) for all wrappers (test_blockmatrix.jl:23-31)."""
    A = build("sphere", np.complex128, bst.SERIAL)
    for op in (A, A.T, A.H, A.conj()):
        repr(op)
        bst.show(op, width=20, height=8)
    out = capsys.readouterr().out
    assert "non-zero entries" in out
