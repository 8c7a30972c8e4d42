"""JAX-transform integration: grad, vmap, from_dense, static quality."""

import compileall
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.testmatrices import random_block_sparse

TOL = 1e-12


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    return float(np.max(np.abs(a - b))) / scale


def build(seed=81, n=150, dtype=np.float64):
    blocks, rows, cols, shape = random_block_sparse(
        seed, shape=(n, n), nblocks=12, max_block=20, dtype=dtype
    )
    return bst.BlockSparseMatrix(blocks, rows, cols, shape), shape


def test_grad_through_product(rng):
    """Block values are differentiable pytree leaves."""
    A, (n, _) = build()
    x = jnp.asarray(rng.standard_normal(n))

    def loss(op):
        y = op @ x
        return jnp.sum(y**2)

    # index tables are int32 leaves -> allow_int yields float0 tangents there
    g = jax.grad(loss, allow_int=True)(A)
    # gradient is an operator-shaped pytree with same structure
    leaves_a = jax.tree_util.tree_leaves(A)
    leaves_g = jax.tree_util.tree_leaves(g)
    assert len(leaves_a) == len(leaves_g)
    assert all(la.shape == lg.shape for la, lg in zip(leaves_a, leaves_g))
    # finite-difference check on one block entry
    eps = 1e-6
    bi, slot = A.layout.block_loc[0][:2]
    vals = A._buckets[bi][0]
    bumped = vals.at[slot, 0, 0].add(eps)
    A2 = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(A),
        [bumped if l is vals else l for l in leaves_a],
    )
    fd = (loss(A2) - loss(A)) / eps
    gval = jax.tree_util.tree_leaves(g)[
        [i for i, l in enumerate(leaves_a) if l is vals][0]
    ][slot, 0, 0]
    assert abs(float(fd) - float(gval)) < 1e-4 * max(1.0, abs(float(gval)))


def test_vmap_over_rhs_batch(rng):
    A, (n, _) = build()
    S = bst.to_scipy(A)
    Xb = rng.standard_normal((5, n))
    Yb = jax.vmap(lambda v: A @ v)(jnp.asarray(Xb))
    for i in range(5):
        assert relerr(Yb[i], S @ Xb[i]) < TOL


def test_from_dense_roundtrip(rng):
    D = np.zeros((40, 40))
    D[0:8, 8:16] = rng.standard_normal((8, 8))
    D[16:24, 16:24] = rng.standard_normal((8, 8))
    A = bst.from_dense(D, 8)
    assert A.nblocks == 2
    assert relerr(A.todense(), D) < TOL
    x = rng.standard_normal(40)
    assert relerr(A @ x, D @ x) < TOL


def test_package_compiles_cleanly():
    """Static-quality analog of the reference's Aqua check: every module in
    the package byte-compiles."""
    pkg = pathlib.Path(bst.__file__).parent
    assert compileall.compile_dir(str(pkg), quiet=2, force=False)


def test_public_api_exports():
    for name in bst.__all__:
        assert hasattr(bst, name), f"missing export {name}"
