"""Oracle parity on the reference's REAL BEM fixture.

Runs the full battery of test/test_symmetricblockmatrix.jl:9-108 on the
actual ``test/assets/symmetricblockexamples.jld2`` data (ComplexF64
sphere/cuboid near-field decompositions, sorted-but-scattered index
lists), not on statistics-matched synthetic fixtures: products,
adjoint/transpose, 5-arg mul! with alpha=im beta=2im, dense
materialization, issymmetric, and the nnz identities, all at the
reference's 1e-13 tolerance against the scipy oracle.
"""

import os

import numpy as np
import pytest

import blocksparse as bst

FIXTURE = "/root/reference/test/assets/symmetricblockexamples.jld2"
TOL = 1e-13

pytestmark = pytest.mark.skipif(
    not os.path.exists(FIXTURE), reason="reference fixture mount not present"
)


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


@pytest.fixture(scope="module")
def blockdict():
    h5py = pytest.importorskip("h5py")  # noqa: F841
    from blocksparse.interop.jld2 import load_symmetric_examples

    return load_symmetric_examples(FIXTURE)


def build(blockdict, example, schedule):
    diagonals, selfindices, offblocks, testindices, trialindices = blockdict[example]
    # size1/size2 from the index maxima, as the reference computes them
    # (test_symmetricblockmatrix.jl:18-19; 0-based here).
    size1 = max(int(r.max()) for r in testindices) + 1
    size2 = max(int(c.max()) for c in trialindices) + 1
    assert size1 == size2
    return bst.SymmetricBlockMatrix(
        diagonals,
        selfindices,
        offblocks,
        testindices,
        trialindices,
        (size1, size2),
        schedule=schedule,
        granularity=(8, 8),
    )


@pytest.fixture(scope="module", params=["sphere", "cuboid"])
def case(request, blockdict):
    b = build(blockdict, request.param, bst.SERIAL)
    bparallel = build(blockdict, request.param, bst.COLORED)
    return b, bparallel, bst.to_scipy(b)


def test_scattered_sorted_indices(blockdict):
    """The fixture genuinely exercises scattered gather lists: sorted but
    non-contiguous (SURVEY 4; e.g. cuboid rowlist [43,44,58,59])."""
    for name in ("sphere", "cuboid"):
        _, selfi, _, testi, _ = blockdict[name]
        assert all(np.all(np.diff(r) > 0) for r in testi)
        noncontig = sum(bool(np.any(np.diff(r) > 1)) for r in testi)
        assert noncontig > len(testi) // 2


def test_issymmetric(case):
    """Parity: issymmetric(sparse(b)) (test_symmetricblockmatrix.jl:49)."""
    _, _, S = case
    d = (S - S.T).tocoo()
    assert relerr(d.data, np.zeros_like(d.data)) < TOL


def test_dense_materialization(case):
    """Parity: sparse(b[:, :]) vs oracle, incl. adjoint/transpose wrappers
    (test_symmetricblockmatrix.jl:54-64)."""
    b, bparallel, S = case
    dense = S.toarray()
    for op in (b, bparallel):
        assert relerr(op.todense(), dense) < TOL
        assert relerr(op.T.todense(), dense.T) < TOL
        assert relerr(op.H.todense(), dense.conj().T) < TOL


def test_products_and_axpby(case, rng):
    """Parity: the 10-random-vector battery with 5-arg mul!(x, ., y, im, 2im)
    (test_symmetricblockmatrix.jl:66-97)."""
    b, bparallel, S = case
    n = b.shape[1]
    for _ in range(10):
        y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        for op in (b, bparallel):
            assert relerr(op @ y, S @ y) < TOL
            assert relerr(op.H @ y, S.conj().T @ y) < TOL
            assert relerr(op.T @ y, S.T @ y) < TOL
            assert relerr(op.axpby(y, x, 1j, 2j), 1j * (S @ y) + 2j * x) < TOL
            assert relerr(
                op.H.axpby(y, x, 1j, 2j), 1j * (S.conj().T @ y) + 2j * x
            ) < TOL
            assert relerr(
                op.T.axpby(y, x, 1j, 2j), 1j * (S.T @ y) + 2j * x
            ) < TOL


def test_nnz(case):
    """Parity: nnz(b) == nnz(bsparse) across wrappers
    (test_symmetricblockmatrix.jl:99-107)."""
    b, bparallel, S = case
    for op in (b, bparallel):
        assert bst.nnz(op) == S.nnz
        assert bst.nnz(op.T) == S.nnz
        assert bst.nnz(op.H) == S.nnz


def test_display_smoke(case, capsys):
    """Parity: @test_nowarn println(b/b'/transpose(b))
    (test_symmetricblockmatrix.jl:30-46)."""
    b, bparallel, _ = case
    for op in (b, b.T, b.H, bparallel, bparallel.T, bparallel.H):
        bst.show(op, width=24, height=10)
    assert "non-zero entries" in capsys.readouterr().out


def test_split_complex_route(case, rng):
    """The split re/im form of this fixture (``bst.split_complex``),
    checked against the same oracle on CPU at f64 split precision."""
    b, _, S = case
    P = bst.split_complex(b)
    y = rng.standard_normal(b.shape[1]) + 1j * rng.standard_normal(b.shape[1])
    yr, yi = P.mv_split(y.real, y.imag)
    ref = S @ y
    assert relerr(np.asarray(yr) + 1j * np.asarray(yi), ref) < TOL
