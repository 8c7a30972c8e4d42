"""Interop with ``jax.experimental.sparse`` (BCOO).

The reference converts to Julia's ``SparseMatrixCSC``
(src/sparse.jl:127-129); the JAX-ecosystem analog of a
general on-device sparse type is ``jax.experimental.sparse.BCOO``.  This
module converts both ways so block-sparse operators can feed code written
against jax's sparse API (e.g. ``sparse.sparsify``-transformed programs)
and general BCOO data can be re-blocked into the dense-block formats.

Duplicate (i, j) entries from overlapping blocks are summed, matching both
the reference's ``sparse`` semantics and this package's ``mul``
accumulation.
"""

from __future__ import annotations

import numpy as np

from ..core.operator import LinearOperator
from ..formats.block_sparse import BlockSparseMatrix
from .scipy_io import from_scipy_blocks, rowcolvals

__all__ = ["to_bcoo", "from_bcoo"]


def to_bcoo(A: LinearOperator):
    """Assemble a :class:`jax.experimental.sparse.BCOO` (duplicates summed,
    indices sorted) from any block format or lazy wrapper."""
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    r, c, v = rowcolvals(A)
    idx = jnp.stack([jnp.asarray(np.asarray(r)), jnp.asarray(np.asarray(c))], axis=1)
    mat = jsparse.BCOO((jnp.asarray(np.asarray(v)), idx), shape=tuple(A.shape))
    return mat.sum_duplicates().sort_indices()


def from_bcoo(mat, block_size, *, dtype=None, **kwargs) -> BlockSparseMatrix:
    """Re-block a BCOO matrix into a :class:`BlockSparseMatrix` with uniform
    ``block_size`` tiles (an int or ``(rows, cols)`` pair; nonempty tiles
    only).  Extra kwargs (``schedule``, ``backend``, ...) pass through to
    the constructor."""
    import scipy.sparse as sp

    if mat.n_batch or mat.n_dense:
        raise ValueError("only 2-D unbatched BCOO is supported")
    data = np.asarray(mat.data)
    idx = np.asarray(mat.indices)
    S = sp.coo_array((data, (idx[:, 0], idx[:, 1])), shape=tuple(mat.shape))
    return from_scipy_blocks(S, block_size, dtype=dtype, **kwargs)
