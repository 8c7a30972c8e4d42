"""Iterative solvers over block operators, vs scipy/numpy oracles.

Parity target: the reference plugs into Krylov packages through LinearMaps
(/root/reference/src/abstractblockmatrix.jl:13); here the solvers consume the
operators directly and must reproduce dense solves at f64 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np

import blocksparse as bst
from blocksparse.utils import testmatrices as tm

TOL = 1e-10


def _spd_operator(seed=0, n=600, dtype=np.float64):
    """SPD block operator: S = B + B^T structure with strong diagonal."""
    d, di, o, ri, ci, shape = tm.random_symmetric(
        seed, n=n, ngroups=24, noffdiag=40, dtype=dtype
    )
    # make blocks symmetric-positive-definite-ish: small off-diag, heavy diag
    d = [0.05 * (b + b.T.conj()) + np.eye(len(b), dtype=dtype) * len(b) for b in d]
    o = [0.05 * b for b in o]
    S = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    return S


def test_cg_matches_dense_solve():
    S = _spd_operator()
    A = np.asarray(bst.to_scipy(S).todense())
    rng = np.random.default_rng(1)
    b = rng.standard_normal(S.shape[0])
    x, info = bst.cg(S, jnp.asarray(b), tol=1e-12, maxiter=2000)
    assert bool(info.converged)
    assert int(info.iterations) > 0
    x_ref = np.linalg.solve(A, b)
    assert np.linalg.norm(np.asarray(x) - x_ref) / np.linalg.norm(x_ref) < 1e-8


def test_cg_preconditioned_converges_faster():
    S = _spd_operator()
    A = bst.to_scipy(S)
    dinv = 1.0 / A.diagonal()
    M = lambda r: jnp.asarray(dinv) * r  # Jacobi
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(S.shape[0]))
    _, plain = bst.cg(S, b, tol=1e-10)
    _, pre = bst.cg(S, b, tol=1e-10, M=M)
    assert bool(pre.converged) and bool(plain.converged)
    assert int(pre.iterations) <= int(plain.iterations)


def test_cg_complex_hermitian():
    d, di, o, ri, ci, shape = tm.random_symmetric(
        3, n=400, ngroups=16, noffdiag=24, dtype=np.complex128
    )
    # Hermitian PD: hermitize diagonals, shrink off-diagonals, shift
    d = [0.05 * (b + b.conj().T) + np.eye(len(b)) * len(b) for b in d]
    o = [0.05 * b for b in o]
    # SymmetricBlockMatrix is symmetric (S = D + O + O^T); for a Hermitian
    # test use real symmetric data in complex dtype
    d = [b.real.astype(np.complex128) for b in d]
    o = [b.real.astype(np.complex128) for b in o]
    S = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    A = np.asarray(bst.to_scipy(S).todense())
    rng = np.random.default_rng(4)
    b = rng.standard_normal(shape[0]) + 1j * rng.standard_normal(shape[0])
    x, info = bst.cg(S, jnp.asarray(b), tol=1e-12)
    assert bool(info.converged)
    x_ref = np.linalg.solve(A, b)
    assert np.linalg.norm(np.asarray(x) - x_ref) / np.linalg.norm(x_ref) < 1e-8


def test_bicgstab_nonsymmetric():
    blocks, rows, cols, shape = tm.random_block_sparse(
        5, shape=(500, 500), nblocks=60, max_block=40, dtype=np.float64
    )
    # diagonally dominate via an added identity-band block structure
    eye_blocks = [np.eye(50) * 40.0 for _ in range(10)]
    eye_idx = [np.arange(i * 50, (i + 1) * 50) for i in range(10)]
    A = bst.BlockSparseMatrix(
        list(blocks) + eye_blocks,
        list(rows) + eye_idx,
        list(cols) + eye_idx,
        shape,
    )
    D = np.asarray(bst.to_scipy(A).todense())
    rng = np.random.default_rng(6)
    b = rng.standard_normal(shape[0])
    x, info = bst.bicgstab(A, jnp.asarray(b), tol=1e-12, maxiter=4000)
    assert bool(info.converged)
    x_ref = np.linalg.solve(D, b)
    assert np.linalg.norm(np.asarray(x) - x_ref) / np.linalg.norm(x_ref) < 1e-6


def test_gmres_native():
    """Native restarted GMRES (Arnoldi + Givens) reports true iterations."""
    S = _spd_operator(seed=7, n=300)
    rng = np.random.default_rng(8)
    b = jnp.asarray(rng.standard_normal(S.shape[0]))
    x, info = bst.gmres(S, b, tol=1e-10, restart=40, maxiter=400)
    assert bool(info.converged)
    assert int(info.iterations) > 0          # real count, not the old -1
    r = np.asarray(b) - np.asarray(S.mv(x))
    assert np.linalg.norm(r) <= max(1e-10 * np.linalg.norm(np.asarray(b)), 1e-12) * 10


def test_gmres_matches_scipy():
    """Iterate-for-iterate quality vs scipy.sparse.linalg.gmres on a
    nonsymmetric operator (the reference oracle pattern, solver edition)."""
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(21)
    n = 180
    A = np.eye(n) * 8 + 0.5 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    x, info = bst.gmres(jnp.asarray(A), jnp.asarray(b), tol=1e-12,
                        restart=30, maxiter=600)
    x_sp, code = spla.gmres(A, b, rtol=1e-12, restart=30, maxiter=600)
    assert code == 0 and bool(info.converged)
    ref = np.linalg.solve(A, b)
    assert np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref) < 1e-9
    assert np.linalg.norm(x_sp - ref) / np.linalg.norm(ref) < 1e-9


def test_gmres_complex_and_preconditioned():
    rng = np.random.default_rng(22)
    n = 120
    A = (np.eye(n) * 6 + 0.4 * (rng.standard_normal((n, n)) +
                                1j * rng.standard_normal((n, n))))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    M = np.diag(1.0 / np.diag(A))
    x, info = bst.gmres(jnp.asarray(A), jnp.asarray(b), tol=1e-12,
                        restart=25, maxiter=500, M=jnp.asarray(M))
    assert bool(info.converged) and int(info.iterations) > 0
    ref = np.linalg.solve(A, b)
    assert np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref) < 1e-8


def test_gmres_under_jit():
    S = _spd_operator(seed=23, n=200)
    b = jnp.asarray(np.random.default_rng(24).standard_normal(S.shape[0]))

    @jax.jit
    def solve(op, rhs):
        x, info = bst.gmres(op, rhs, tol=1e-10, restart=30)
        return x, info.iterations

    x, iters = solve(S, b)
    r = np.asarray(S.mv(x)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8
    assert int(iters) > 0


def test_cg_under_jit():
    S = _spd_operator(seed=9, n=300)
    b = jnp.asarray(np.random.default_rng(10).standard_normal(S.shape[0]))

    @jax.jit
    def solve(op, rhs):
        x, info = bst.cg(op, rhs, tol=1e-10)
        return x, info.iterations

    x, iters = solve(S, b)
    r = np.asarray(S.mv(x)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-9
    assert int(iters) > 0


def test_solver_accepts_dense_and_callable():
    rng = np.random.default_rng(11)
    n = 64
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x1, i1 = bst.cg(jnp.asarray(A), jnp.asarray(b), tol=1e-12)
    x2, i2 = bst.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12)
    ref = np.linalg.solve(A, b)
    assert np.allclose(np.asarray(x1), ref, atol=1e-8)
    assert np.allclose(np.asarray(x2), ref, atol=1e-8)
    assert int(i1.iterations) == int(i2.iterations)
