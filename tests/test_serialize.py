"""Save/load round-trip tests for all three formats."""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import (
    random_block_sparse,
    random_symmetric,
    random_vbcrs,
)

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def test_roundtrip_block_sparse(tmp_path, rng):
    blocks, rows, cols, shape = random_block_sparse(
        71, shape=(300, 300), nblocks=20, max_block=30, dtype=np.complex128
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape, schedule="colored")
    p = tmp_path / "a.npz"
    bst.save(p, A)
    B = bst.load(p)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    assert relerr(B @ x, A @ x) < TOL
    assert B.schedule == A.schedule and B.nnz == A.nnz and B.shape == A.shape


def test_roundtrip_symmetric(tmp_path, rng):
    d, di, o, ri, ci, shape = random_symmetric(
        72, n=250, ngroups=8, noffdiag=10, dtype=np.complex128
    )
    S = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    p = tmp_path / "s.npz"
    bst.save(p, S)
    S2 = bst.load(p)
    x = rng.standard_normal(250) + 1j * rng.standard_normal(250)
    assert relerr(S2 @ x, S @ x) < TOL
    assert relerr(S2.H @ x, S.H @ x) < TOL
    assert S2.nnz == S.nnz


def test_roundtrip_vbcrs(tmp_path, rng):
    blocks, rs, cs, shape = random_vbcrs(73, shape=(300, 300), nrowgroups=6,
                                         ncolgroups=6)
    V = bst.VariableBlockCompressedRowStorage(blocks, rs, cs, shape)
    p = tmp_path / "v.npz"
    bst.save(p, V)
    V2 = bst.load(p, backend="xla")
    x = rng.standard_normal(300)
    assert relerr(V2 @ x, V @ x) < TOL
    assert V2.rowptr == V.rowptr


def _legacy_file(tmp_path, A, **fields):
    """Save ``A``, then rewrite the file with extra top-level fields, as
    files from earlier versions carry them."""
    p = tmp_path / "legacy.npz"
    bst.save(p, A)
    with np.load(p) as data:
        meta = dict(data)
    meta.update({k: np.str_(v) for k, v in fields.items()})
    np.savez_compressed(p, **meta)
    return p


def test_roundtrip_autotune_policy(tmp_path, rng):
    """A file carrying the removed autotune policy (and a removed engine
    name) loads; the fields are ignored and the product is unchanged."""
    blocks, rows, cols, shape = random_block_sparse(
        75, shape=(256, 256), nblocks=12, max_block=32, dtype=np.float32
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    p = _legacy_file(tmp_path, A, autotune='{"spmv": "pallas"}',
                     backend="pallas")
    B = bst.load(p)
    assert B._backend == "auto"
    x = rng.standard_normal(256).astype(np.float32)
    assert relerr(B @ x, bst.to_scipy(A) @ x) < 1e-5


def test_save_wrapper_rejected(tmp_path):
    blocks, rows, cols, shape = random_block_sparse(
        74, shape=(100, 100), nblocks=5, max_block=10, dtype=np.float64
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    with pytest.raises(TypeError):
        bst.save(tmp_path / "t.npz", A.T)


def test_roundtrip_optimize(tmp_path):
    """A file carrying the removed ``optimize`` plan bias loads and ignores
    it; load-time overrides still win."""
    blocks, rows, cols, shape = random_block_sparse(
        81, shape=(256, 256), nblocks=6, max_block=32, dtype=np.float32,
        contiguous=True,
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    p = _legacy_file(tmp_path, A, optimize="latency")
    B = bst.load(p)
    assert not hasattr(B, "_optimize") and B._backend == "xla"
    C = bst.load(p, backend="auto")
    assert C._backend == "auto"
    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    assert relerr(C @ x, bst.to_scipy(A) @ x) < 1e-5
