"""Batched multi-operand products (ops/batched.py): P products in one call.

Correctness vs per-operator scipy oracles, gradient exactness, mixed
structures, and input guards.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import blocksparse as bst

TOL = 2e-5


def build(seed, n=512, nblocks=10, bs=32, backend="xla"):
    rng = np.random.default_rng(7)      # fixed structure
    vrng = np.random.default_rng(seed)  # per-op values
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    rows = (pos // ntiles) * bs
    cols = (pos % ntiles) * bs
    return bst.BlockSparseMatrix(
        [vrng.standard_normal((bs, bs)).astype(np.float32)
         for _ in range(nblocks)],
        [np.arange(r, r + bs) for r in rows],
        [np.arange(c, c + bs) for c in cols],
        (n, n),
        backend=backend,
    )


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


@pytest.fixture(scope="module")
def ops():
    return [build(seed) for seed in (1, 2, 3)]


def test_batched_matches_oracles(ops, rng):
    Xs = rng.standard_normal((3, 512, 24)).astype(np.float32)
    out = bst.batched_mm(ops, Xs)
    assert out.shape == (3, 512, 24)
    for p, op in enumerate(ops):
        assert relerr(out[p], bst.to_scipy(op) @ Xs[p]) < TOL


def test_batched_list_input(ops, rng):
    Xs = [rng.standard_normal((512, 8)).astype(np.float32) for _ in range(3)]
    out = bst.batched_mm(ops, Xs)
    for p, op in enumerate(ops):
        assert relerr(out[p], bst.to_scipy(op) @ Xs[p]) < TOL


def test_batched_r_slicing(ops, rng):
    """A wide RHS (r = 136) through the batched path."""
    r = 136
    Xs = rng.standard_normal((3, 512, r)).astype(np.float32)
    out = bst.batched_mm(ops, Xs)
    for p, op in enumerate(ops):
        assert relerr(out[p], bst.to_scipy(op) @ Xs[p]) < TOL


def test_batched_grad(ops, rng):
    """Exact cotangents in Xs."""
    Xs = jnp.asarray(rng.standard_normal((3, 512, 8)).astype(np.float32))

    def f(Xs):
        return jnp.sum(bst.batched_mm(ops, Xs) ** 2)

    g = jax.grad(f)(Xs)
    # reference gradient via the scipy oracle: d/dX ||A X||^2 = 2 A^T A X
    for p, op in enumerate(ops):
        S = bst.to_scipy(op)
        ref = 2 * (S.T @ (S @ np.asarray(Xs[p])))
        assert relerr(g[p], ref) < 5e-4


def test_fallback_on_mixed_structure(rng):
    """Different block structures loop per-operator (identical semantics)."""
    a = build(1, nblocks=10)
    b = build(2, nblocks=11)
    Xs = rng.standard_normal((2, 512, 8)).astype(np.float32)
    out = bst.batched_mm([a, b], Xs)
    assert relerr(out[0], bst.to_scipy(a) @ Xs[0]) < TOL
    assert relerr(out[1], bst.to_scipy(b) @ Xs[1]) < TOL


def test_fallback_on_xla_backend(rng):
    ops = [build(s, backend="auto") for s in (1, 2)]
    Xs = rng.standard_normal((2, 512, 8)).astype(np.float32)
    out = bst.batched_mm(ops, Xs)
    for p, op in enumerate(ops):
        assert relerr(out[p], bst.to_scipy(op) @ Xs[p]) < TOL


def test_guards(ops, rng):
    with pytest.raises(ValueError, match="leading dim"):
        bst.batched_mm(ops, rng.standard_normal((2, 512, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="P, n, r"):
        bst.batched_mm(ops, rng.standard_normal((3, 512)).astype(np.float32))


# ---------------------------------------------------------------------------
# batched_mv
# ---------------------------------------------------------------------------


def build_sym(seed, backend="xla"):
    from blocksparse.utils.testmatrices import random_symmetric

    d, di, o, ri, ci, shape = random_symmetric(
        9, n=640, ngroups=10, noffdiag=14, dtype=np.float32,
        contiguous=True,
    )
    vr = np.random.default_rng(seed)
    d = [vr.standard_normal(b.shape).astype(np.float32) for b in d]
    o = [vr.standard_normal(b.shape).astype(np.float32) for b in o]
    return bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape,
                                    backend=backend)


def test_batched_mv_symmetric(rng):
    ops = [build_sym(s) for s in (1, 2, 3)]
    xs = rng.standard_normal((3, ops[0].shape[1])).astype(np.float32)
    out = bst.batched_mv(ops, xs)
    assert out.shape == (3, ops[0].shape[0])
    for p, op in enumerate(ops):
        assert relerr(out[p], bst.to_scipy(op) @ xs[p]) < TOL


def test_batched_mv_general(rng):
    ops = [build(s) for s in (4, 5)]
    xs = [rng.standard_normal(512).astype(np.float32) for _ in range(2)]
    out = bst.batched_mv(ops, xs)
    for p, op in enumerate(ops):
        assert relerr(out[p], bst.to_scipy(op) @ xs[p]) < TOL


def test_batched_mv_grad(rng):
    ops = [build_sym(s) for s in (1, 2)]
    xs = jnp.asarray(
        rng.standard_normal((2, ops[0].shape[1])).astype(np.float32))

    def f(xs):
        return jnp.sum(bst.batched_mv(ops, xs) ** 2)

    g = jax.grad(f)(xs)
    for p, op in enumerate(ops):
        S = bst.to_scipy(op)
        ref = 2 * (S.T @ (S @ np.asarray(xs[p])))
        assert relerr(g[p], ref) < 5e-4


def test_batched_mv_fallback_mixed(rng):
    """Different structures -> per-operator loop, identical results."""
    a = build_sym(1)
    from blocksparse.utils.testmatrices import random_symmetric

    d, di, o, ri, ci, shape = random_symmetric(
        10, n=640, ngroups=11, noffdiag=12, dtype=np.float32,
        contiguous=True,
    )
    b = bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape)
    xs = rng.standard_normal((2, 640)).astype(np.float32)
    out = bst.batched_mv([a, b], xs)
    assert relerr(out[0], bst.to_scipy(a) @ xs[0]) < TOL
    assert relerr(out[1], bst.to_scipy(b) @ xs[1]) < TOL


def test_jit_first_no_tracer_leak(rng):
    """An operator/batch whose FIRST product happens inside a jit trace
    must not leak trace-local device arrays into later traces (the
    host-table caches of ops/xla_spmv.py build device copies only
    outside a trace)."""
    ops = [build(s) for s in (6, 7)]
    Xs = jnp.asarray(rng.standard_normal((2, 512, 8)).astype(np.float32))
    o1 = jax.jit(lambda X: bst.batched_mm(ops, X))(Xs)
    o2 = jax.jit(lambda X: bst.batched_mm(ops, X) * 2.0)(Xs)   # 2nd trace
    o3 = bst.batched_mm(ops, Xs)                               # eager
    for p, op in enumerate(ops):
        ref = bst.to_scipy(op) @ np.asarray(Xs[p])
        assert relerr(o1[p], ref) < TOL
        assert relerr(o2[p], 2 * ref) < TOL
        assert relerr(o3[p], ref) < TOL
    # regular operator: first product under jit, then a second trace
    A = build(8)
    x = jnp.asarray(rng.standard_normal(512).astype(np.float32))
    r1 = jax.jit(lambda v: A @ v)(x)
    r2 = jax.jit(lambda v: (A @ v) * 3.0)(x)
    ref = bst.to_scipy(A) @ np.asarray(x)
    assert relerr(r1, ref) < TOL and relerr(r2, 3 * ref) < TOL
