"""Distributed-layer tests on a virtual 8-device CPU mesh.

The JAX analog of testing multi-node without a cluster (SURVEY.md §4):
``--xla_force_host_platform_device_count=8`` is set in conftest.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import blocksparse as bst
from blocksparse.parallel.distributed import distribute
from blocksparse.utils.testmatrices import (
    random_block_sparse,
    random_symmetric,
    random_vbcrs,
)

TOL = 1e-12


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def mesh_of(n):
    devs = jax.devices()
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    return Mesh(np.array(devs[:n]), ("rows",))


@pytest.mark.parametrize("nshards", [2, 8])
def test_block_sparse_spmv(nshards, rng):
    blocks, rows, cols, shape = random_block_sparse(
        41, shape=(519, 519), nblocks=40, max_block=50, dtype=np.float64
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    D = distribute(A, mesh_of(nshards))
    x = rng.standard_normal(shape[1])
    assert relerr(D.mv(x), A @ x) < TOL


def test_symmetric_spmv_single_stored(rng):
    """Half-stored off-diagonals distribute WITHOUT host-side expansion:
    the mirrored contribution is fused into the same pass (VERDICT #4) and
    lands on remote rows through the reverse halo exchange."""
    d, di, o, ri, ci, shape = random_symmetric(
        42, n=640, ngroups=16, noffdiag=40, dtype=np.float64
    )
    S_op = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    D = distribute(S_op, mesh_of(8))
    # single storage: nonzero values on device == one copy of each block
    # (the round-1 design expanded every off-diagonal twice host-side)
    stored_nnz = sum(
        int(np.count_nonzero(np.asarray(grp[0])))
        for part in D._arrays[2] for row in part for grp in row
        if grp is not None
    )
    logical = sum(np.count_nonzero(b) for b in d) + sum(
        np.count_nonzero(b) for b in o
    )
    assert stored_nnz == logical
    assert D.row_halo.dists  # scattered structure must cross shards
    x = rng.standard_normal(shape[1])
    assert relerr(D.mv(x), S_op @ x) < TOL
    # symmetric transpose/adjoint ride the same storage
    assert relerr(D.T @ x, S_op.T @ x) < TOL


def test_halo_traffic_beats_all_gather(rng):
    """VERDICT #4 'done' criterion: exchanged bytes << full-x bytes.

    The fixture mirrors the reference's BEM near-field structure
    (docs/src/block.md:4): off-diagonal coupling only between NEIGHBORING
    index groups, so each shard's halo is a thin boundary layer while an
    all_gather would move all of x to every shard."""
    n, ngroups = 8192, 64
    gsz = n // ngroups
    rg = np.random.default_rng(46)
    d = [rg.standard_normal((gsz, gsz)) for _ in range(ngroups)]
    di = [np.arange(i * gsz, (i + 1) * gsz) for i in range(ngroups)]
    o, ri, ci = [], [], []
    for i in range(ngroups - 1):  # nearest-neighbor coupling only
        o.append(rg.standard_normal((gsz, gsz)))
        ri.append(np.arange(i * gsz, (i + 1) * gsz))
        ci.append(np.arange((i + 1) * gsz, (i + 2) * gsz))
    S_op = bst.SymmetricBlockMatrix(d, di, o, ri, ci, (n, n))
    S = 8
    D = distribute(S_op, mesh_of(S))
    n_padded = S * D._meta.cols_per
    all_gather_bytes = (S - 1) * n_padded * 4 * S  # what the old design moved
    assert D.exchanged_bytes_per_call < all_gather_bytes / 10
    x = rng.standard_normal(n)
    assert relerr(D.mv(x), S_op @ x) < TOL


def test_vbcrs_spmm(rng):
    blocks, rstarts, cstarts, shape = random_vbcrs(
        43, shape=(800, 800), nrowgroups=16, ncolgroups=16, dtype=np.float64
    )
    V = bst.VariableBlockCompressedRowStorage(blocks, rstarts, cstarts, shape)
    D = distribute(V, mesh_of(4))
    X = rng.standard_normal((shape[1], 6))
    assert relerr(D.mm(X), V @ X) < TOL


def test_transpose_and_adjoint_distribution(rng):
    """distribute(A.T) and distribute(A).T share one device copy; the
    transpose product reuses the stacked values with swapped tables."""
    blocks, rows, cols, shape = random_block_sparse(
        44, shape=(512, 512), nblocks=30, max_block=40, dtype=np.complex128
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    x = rng.standard_normal(shape[0]) + 1j * rng.standard_normal(shape[0])
    Dt = distribute(A.T, mesh_of(4))
    Dh = distribute(A.H, mesh_of(4))
    assert relerr(Dt.mv(x), A.T @ x) < TOL
    assert relerr(Dh.mv(x), A.H @ x) < TOL
    D = distribute(A, mesh_of(4))
    assert relerr(D.T @ x, A.T @ x) < TOL
    assert relerr(D.H @ x, A.H @ x) < TOL
    assert relerr(D.conj() @ x, A.conj() @ x) < TOL


def test_rectangular_transpose(rng):
    """Non-square: the transpose product crosses between the row and col
    partitions (different halo plans per side)."""
    blocks, rows, cols, shape = random_block_sparse(
        47, shape=(700, 350), nblocks=30, max_block=40, dtype=np.float64
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    D = distribute(A, mesh_of(4))
    x = rng.standard_normal(shape[1])
    xt = rng.standard_normal(shape[0])
    assert relerr(D @ x, A @ x) < TOL
    assert relerr(D.T @ xt, A.T @ xt) < TOL


def test_operator_algebra(rng):
    """Full LinearOperator surface under distribution (VERDICT #6):
    axpby, scaling, sum, composition."""
    blocks, rows, cols, shape = random_block_sparse(
        48, shape=(512, 512), nblocks=25, max_block=40, dtype=np.float64
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    D = distribute(A, mesh_of(4))
    x = rng.standard_normal(shape[1])
    y = rng.standard_normal(shape[0])
    ref = 2.5 * np.asarray(A @ x) + 0.5 * y
    assert relerr(D.axpby(x, y, 2.5, 0.5), ref) < TOL
    assert relerr((3.0 * D) @ x, 3.0 * np.asarray(A @ x)) < TOL
    assert relerr((D + D) @ x, 2.0 * np.asarray(A @ x)) < TOL
    assert relerr((D.T @ D) @ x, A.T @ (A @ x)) < TOL


def test_distributed_cg(rng):
    """VERDICT #7 'done' criterion: CG solves an SPD block system on the
    8-device mesh through the operator's solver closure."""
    d, di, o, ri, ci, shape = random_symmetric(
        49, n=512, ngroups=16, noffdiag=24, dtype=np.float64
    )
    # make it SPD: S + lam*I via operator algebra would need an identity
    # operator; instead strengthen the diagonal blocks.
    d = [b + b.T + 50.0 * np.eye(b.shape[0]) for b in d]
    S_op = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    D = distribute(S_op, mesh_of(8))
    b = rng.standard_normal(shape[0])
    x, _ = jax.scipy.sparse.linalg.cg(
        D.matvec_closure(), jnp.asarray(b), tol=1e-10, maxiter=500
    )
    res = np.asarray(S_op @ x) - b
    assert float(np.linalg.norm(res) / np.linalg.norm(b)) < 1e-8


def test_uneven_rows(rng):
    """nrows not divisible by nshards -> padded partition."""
    blocks, rows, cols, shape = random_block_sparse(
        45, shape=(501, 503), nblocks=25, max_block=30, dtype=np.float64
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape)
    D = distribute(A, mesh_of(8))
    x = rng.standard_normal(shape[1])
    assert relerr(D.mv(x), A @ x) < TOL


def test_spmm_wide_rhs(rng):
    """SpMM with a 64-col RHS on the mesh (VERDICT #7)."""
    d, di, o, ri, ci, shape = random_symmetric(
        50, n=512, ngroups=16, noffdiag=24, dtype=np.float64
    )
    S_op = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    D = distribute(S_op, mesh_of(8))
    X = rng.standard_normal((shape[1], 64))
    assert relerr(D.mm(X), S_op @ X) < TOL


def test_2d_mesh_spmm(rng):
    """2-D block-rows x RHS-columns mesh: matrix replicates over the rhs
    axis, each RHS column group runs its own halo ring, output comes back
    sharded over both axes (docs/distributed.md '2-D meshes for SpMM')."""
    devs = jax.devices()
    mesh2 = Mesh(np.array(devs[:8]).reshape(4, 2), ("rows", "rhs"))
    blocks, rows, cols, shape = random_block_sparse(
        17, shape=(512, 512), nblocks=24, dtype=np.float64, contiguous=True
    )
    A = bst.BlockSparseMatrix(blocks, rows, cols, shape, backend="xla")
    S = bst.to_scipy(A)
    D = distribute(A, mesh2, rhs_axis="rhs")

    X = rng.standard_normal((shape[1], 6))  # r=6: pads to 8 (2 shards of 4)
    Y = D @ jnp.asarray(X)
    assert Y.shape == (shape[0], 6)
    assert relerr(Y, S @ X) < TOL
    # transpose products ride the same 2-D layout
    Yt = D.T @ jnp.asarray(X)
    assert relerr(Yt, S.T @ X) < TOL
    # SpMV ignores the rhs axis
    x = rng.standard_normal(shape[1])
    assert relerr(D @ jnp.asarray(x), S @ x) < TOL
