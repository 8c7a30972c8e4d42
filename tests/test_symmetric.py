"""Oracle tests for SymmetricBlockMatrix (format 2).

Mirrors test/test_symmetricblockmatrix.jl: the scipy oracle is assembled from
off-diagonals, transposed off-diagonals, then diagonals (sparse.jl:42-91);
ComplexF64 with alpha=i, beta=2i distinguishes adjoint from transpose.
"""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_symmetric

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def build(seed, dtype, schedule, symmetric_diag=False, contiguous=False):
    d, di, o, ri, ci, shape = random_symmetric(
        seed, n=1203 if seed == 1 else 1344, dtype=dtype, contiguous=contiguous
    )
    if symmetric_diag:
        d = [(b + b.T) / 2 for b in d]
    # coarse granularity keeps distinct bucket shapes (compile time) low
    return bst.SymmetricBlockMatrix(
        d, di, o, ri, ci, shape, schedule=schedule, granularity=(32, 32)
    )


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize(
    "dtype,schedule",
    [
        (np.float64, bst.SERIAL),
        (np.complex128, bst.COLORED),
    ],
)
def test_oracle_products(seed, dtype, schedule, rng):
    S_op = build(seed, dtype, schedule)
    S = bst.to_scipy(S_op)
    n = S_op.shape[0]

    for _ in range(10):
        x = rng.standard_normal(n)
        y = rng.standard_normal(n)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            x = x + 1j * rng.standard_normal(n)
            y = y + 1j * rng.standard_normal(n)
        assert relerr(S_op @ x, S @ x) < TOL
        assert relerr(S_op.T @ x, S.T @ x) < TOL
        assert relerr(S_op.H @ x, S.conj().T @ x) < TOL
        assert relerr(S_op.conj() @ x, S.conj() @ x) < TOL
        out = S_op.axpby(x, y, 1j, 2j)
        assert relerr(out, 1j * (S @ x) + 2j * y) < TOL


def test_todense_matches_oracle():
    S_op = build(1, np.complex128, bst.SERIAL)
    assert relerr(S_op.todense(), bst.to_scipy(S_op).toarray()) < TOL


def test_symmetric_oracle_is_symmetric(rng):
    """Parity: issymmetric(sparse(S)) (test_symmetricblockmatrix.jl:49) --
    holds when diagonal blocks are symmetric (BEM Galerkin fixtures are)."""
    S_op = build(1, np.complex128, bst.COLORED, symmetric_diag=True)
    S = bst.to_scipy(S_op).toarray()
    assert relerr(S, S.T) < TOL
    # docs sanity check: S*y == transpose(S)*y (docs/src/symmetric.md:109)
    y = rng.standard_normal(S_op.shape[0]) + 1j * rng.standard_normal(S_op.shape[0])
    assert relerr(S_op @ y, S_op.T @ y) < TOL


def test_multi_rhs(rng):
    S_op = build(2, np.complex128, bst.SERIAL)
    S = bst.to_scipy(S_op)
    X = rng.standard_normal((S_op.shape[1], 5)) + 1j * rng.standard_normal(
        (S_op.shape[1], 5)
    )
    assert relerr(S_op @ X, S @ X) < TOL
    assert relerr(S_op.H @ X, S.conj().T @ X) < TOL


def test_nnz_counts_offdiagonals_twice():
    """Parity: symmetricblockmatrix.jl:367-384."""
    S_op = build(1, np.complex128, bst.SERIAL)
    expect = sum(S_op.diagonal(i).size for i in range(S_op.ndiagonals)) + 2 * sum(
        S_op.offdiagonal(i).size for i in range(S_op.noffdiagonals)
    )
    assert bst.nnz(S_op) == expect
    assert bst.nnz(S_op.T) == expect
    assert bst.nnz(S_op.H) == expect


def test_colors_always_computed():
    """Parity: SBM colors all three sets even under serial schedule
    (symmetricblockmatrix.jl:104-110)."""
    import blocksparse.coloring as coloring

    S_op = build(1, np.complex128, bst.SERIAL)
    assert len(S_op.diagonalcolors()) >= 1
    assert len(S_op.offdiagonalcolors()) >= 1
    assert len(S_op.transposeoffdiagonalcolors()) >= 1
    assert len(S_op.fusedcolors()) >= 1
    # fused colors are conflict-free on the union of row+col index sets
    union_lists = [
        np.concatenate([S_op.blockrowindices(i), S_op.blockcolindices(i)])
        for i in range(S_op.noffdiagonals)
    ]
    groups = [np.array(g) for g in S_op.fusedcolors()]
    assert coloring.validate_coloring(union_lists, groups)


@pytest.mark.parametrize("schedule", [bst.SERIAL, bst.COLORED])
def test_unsorted_index_lists(schedule, rng):
    """Unsorted index lists (reference trial lists, SURVEY §4): permuting a
    block's rows/cols together with its index lists leaves the represented
    matrix unchanged, so the sorted and unsorted builds must agree with the
    same oracle -- for both schedules."""
    d, di, o, ri, ci, shape = random_symmetric(
        33, n=900, ngroups=24, noffdiag=40, dtype=np.complex128
    )
    # rebuild with matching permuted index lists
    d2, di2 = [], []
    o2, ri2, ci2 = [], [], []
    prng = np.random.default_rng(5)
    for b, g in zip(d, di):
        p = prng.permutation(len(g))
        d2.append(b[p][:, p])
        di2.append(np.asarray(g)[p])
    for b, r, c in zip(o, ri, ci):
        pr = prng.permutation(len(r))
        pc = prng.permutation(len(c))
        o2.append(b[pr][:, pc])
        ri2.append(np.asarray(r)[pr])
        ci2.append(np.asarray(c)[pc])
    assert any(not np.all(np.diff(r) > 0) for r in ri2)
    S_op = bst.SymmetricBlockMatrix(d2, di2, o2, ri2, ci2, shape,
                                    schedule=schedule, backend="xla")
    S_ref = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    S = bst.to_scipy(S_ref)
    x = rng.standard_normal(shape[0]) + 1j * rng.standard_normal(shape[0])
    assert relerr(S_op @ x, S @ x) < TOL
    assert relerr(S_op.T @ x, S.T @ x) < TOL
    assert relerr(S_op.H @ x, S.conj().T @ x) < TOL


def test_serial_vs_colored_duality(rng):
    a = build(2, np.complex128, bst.SERIAL)
    b = build(2, np.complex128, bst.COLORED)
    x = rng.standard_normal(a.shape[1]) + 1j * rng.standard_normal(a.shape[1])
    assert relerr(a @ x, b @ x) < TOL


def test_display_smoke(capsys):
    S_op = build(1, np.complex128, bst.SERIAL)
    for op in (S_op, S_op.T, S_op.H):
        repr(op)
        bst.show(op, width=20, height=8)
    assert "non-zero entries" in capsys.readouterr().out
