"""Oracle + cross-format tests for VBCRS (format 3).

Mirrors test/test_vbcrs.jl: oracle equivalence plus cross-format product
equality (BSM built from the same blocks, and VBCRS converted from BSM/SBM).
"""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_symmetric, random_vbcrs

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def build(seed=3, dtype=np.float64, schedule=bst.SERIAL):
    blocks, rstarts, cstarts, shape = random_vbcrs(seed, dtype=dtype)
    return (
        bst.VariableBlockCompressedRowStorage(
            blocks, rstarts, cstarts, shape, schedule=schedule, granularity=(32, 32)
        ),
        blocks,
        rstarts,
        cstarts,
        shape,
    )


@pytest.mark.parametrize(
    "dtype,schedule",
    [
        (np.float64, bst.SERIAL),
        (np.complex128, bst.COLORED),
    ],
)
def test_oracle_products(dtype, schedule, rng):
    V, *_ = build(dtype=dtype, schedule=schedule)
    S = bst.to_scipy(V)
    m, n = V.shape
    for _ in range(10):
        x = rng.standard_normal(n)
        y = rng.standard_normal(m)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            x = x + 1j * rng.standard_normal(n)
            y = y + 1j * rng.standard_normal(m)
        assert relerr(V @ x, S @ x) < TOL
        # transpose path: parallel scatter-add (reference's is serial,
        # vbcrs.jl:303-329) -- must still match the oracle
        assert relerr(V.T @ y, S.T @ y) < TOL
        assert relerr(V.H @ y, S.conj().T @ y) < TOL
        out = V.axpby(x, y, 1j if dtype == np.complex128 else 2.0,
                      2j if dtype == np.complex128 else 3.0)
        alpha = 1j if dtype == np.complex128 else 2.0
        beta = 2j if dtype == np.complex128 else 3.0
        assert relerr(out, alpha * (S @ x) + beta * y) < TOL


def test_sorted_csr_structure():
    """Blocks sorted by (row, col); rowptr covers all blocks
    (parity: vbcrs.jl:78-122)."""
    V, blocks, rstarts, cstarts, shape = build()
    assert V.rowptr[0] == 0 and V.rowptr[-1] == V.nblocks
    prev = None
    for i in range(V.nblocks):
        key = (V.row_start(i), V.col_start(i))
        if prev is not None:
            assert key >= prev
        prev = key
    # block rows have strictly increasing row starts
    starts = [V.row_start(V.rowptr[r]) for r in range(V.nblockrows)]
    assert starts == sorted(starts) and len(set(starts)) == len(starts)


def test_cross_format_vs_block_sparse(rng):
    """b*x == v*x for the same blocks (test_vbcrs.jl:19-48)."""
    V, blocks, rstarts, cstarts, shape = build()
    rows = [np.arange(r, r + b.shape[0]) for r, b in zip(rstarts, blocks)]
    cols = [np.arange(c, c + b.shape[1]) for c, b in zip(cstarts, blocks)]
    B = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    x = rng.standard_normal(shape[1])
    assert relerr(B @ x, V @ x) < TOL

    V2 = bst.VariableBlockCompressedRowStorage.from_block_sparse(B)
    assert relerr(V2 @ x, V @ x) < TOL
    assert V2.nnz == V.nnz


def test_from_symmetric_expansion(rng):
    """SBM -> VBCRS expands diag once + offdiag twice (vbcrs.jl:189-199)."""
    d, di, o, ri, ci, shape = random_symmetric(
        5, n=600, ngroups=20, noffdiag=30, dtype=np.float64, contiguous=True
    )
    S_op = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    V = bst.VariableBlockCompressedRowStorage.from_symmetric(S_op)
    x = rng.standard_normal(shape[1])
    assert relerr(V @ x, S_op @ x) < TOL
    assert V.nblocks == S_op.ndiagonals + 2 * S_op.noffdiagonals
    assert V.nnz == bst.nnz(S_op)


def test_contiguity_validation():
    blocks = [np.ones((2, 2))]
    with pytest.raises(ValueError):
        bst.VariableBlockCompressedRowStorage(
            blocks, [np.array([0, 2])], [np.array([0, 1])], (4, 4)
        )
    # scalar starts and full ranges both accepted
    v1 = bst.VariableBlockCompressedRowStorage(blocks, [0], [1], (4, 4))
    v2 = bst.VariableBlockCompressedRowStorage(
        blocks, [np.array([0, 1])], [np.array([1, 2])], (4, 4)
    )
    assert relerr(v1.todense(), v2.todense()) < TOL


def test_unsorted_input_blocks(rng):
    """Blocks may arrive in any order; sorting is internal (vbcrs.jl docs)."""
    blocks, rstarts, cstarts, shape = random_vbcrs(7)
    perm = rng.permutation(len(blocks))
    V1 = bst.VariableBlockCompressedRowStorage(blocks, rstarts, cstarts, shape)
    V2 = bst.VariableBlockCompressedRowStorage(
        [blocks[i] for i in perm],
        [rstarts[i] for i in perm],
        [cstarts[i] for i in perm],
        shape,
    )
    x = rng.standard_normal(shape[1])
    assert relerr(V1 @ x, V2 @ x) < TOL


def test_display_smoke(capsys):
    V, *_ = build()
    for op in (V, V.T, V.H):
        repr(op)
        bst.show(op, width=20, height=8)
    assert "non-zero entries" in capsys.readouterr().out
