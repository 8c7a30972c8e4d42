"""Split-complex execution: complex operators as real re/im pairs.

Complex operators -- the reference's primary BEM use case is ComplexF64 --
run natively on every backend.  This module offers the alternative form of
two real operators (SURVEY.md §7 design stance 8):

    M = R + i*I,   x = xr + i*xi
    M  @ x = (R xr - I xi) + i (I xr + R xi)
    M' semantics follow by flag algebra (conj flips the sign of I; transpose
    passes through to the children).

Four real products per complex product; each child product runs on the
real engines.  Whether that beats the native complex product is not
measured on the H200.

Use :func:`split_complex` on any of the three formats; the resulting
operator exposes the normal algebra (``@``, ``.T``, ``.H``, ``axpby``) plus
``mv_split``/``mm_split`` that take and return real re/im pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .core.operator import LinearOperator
from .formats.block_sparse import BlockSparseMatrix
from .formats.symmetric import SymmetricBlockMatrix
from .formats.vbcrs import VariableBlockCompressedRowStorage

__all__ = ["ComplexSplitOperator", "split_complex", "autosplit"]


def autosplit(op) -> "ComplexSplitOperator":
    """Cached split-real pair for a complex-dtype format operator (serves
    ``LinearOperator.split`` and ``mv_split``/``mm_split``)."""
    cache = getattr(op, "_autosplit_cache", None)
    if cache is None:
        kwargs = {"backend": op._backend}
        if getattr(op, "_precision", None) is not None:
            kwargs["precision"] = op._precision
        cache = split_complex(op, **kwargs)
        op._autosplit_cache = cache
    return cache


def split_complex(op, **kwargs) -> "ComplexSplitOperator":
    """Build a split re/im pair from a complex-dtype format operator.

    ``kwargs`` (backend=, granularity=, precision=, ...) pass to the real
    constructors; defaults are inherited from ``op`` where meaningful.
    """
    kwargs.setdefault("schedule", op.schedule)

    def parts(get_block, n):
        blocks = [get_block(i) for i in range(n)]
        return [np.ascontiguousarray(b.real) for b in blocks], [
            np.ascontiguousarray(b.imag) for b in blocks
        ]

    if isinstance(op, SymmetricBlockMatrix):
        dre, dim = parts(op.diagonal, op.ndiagonals)
        ore, oim = parts(op.offdiagonal, op.noffdiagonals)
        di = [op.diagonalindices(i) for i in range(op.ndiagonals)]
        ri = [op.blockrowindices(i) for i in range(op.noffdiagonals)]
        ci = [op.blockcolindices(i) for i in range(op.noffdiagonals)]
        re = SymmetricBlockMatrix(dre, di, ore, ri, ci, op.shape, **kwargs)
        im = SymmetricBlockMatrix(dim, di, oim, ri, ci, op.shape, **kwargs)
    elif isinstance(op, (BlockSparseMatrix, VariableBlockCompressedRowStorage)):
        bre, bim = parts(op.block, op.nblocks)
        rows = [op.blockrowindices(i) for i in range(op.nblocks)]
        cols = [op.blockcolindices(i) for i in range(op.nblocks)]
        cls = type(op)
        re = cls(bre, rows, cols, op.shape, **kwargs)
        im = cls(bim, rows, cols, op.shape, **kwargs)
    else:
        raise TypeError(f"split_complex: unsupported operator {type(op).__name__}")
    return ComplexSplitOperator(re, im)


@jax.tree_util.register_pytree_node_class
class ComplexSplitOperator(LinearOperator):
    """Complex operator stored as two real operators (re, im)."""

    def __init__(self, re_op: LinearOperator, im_op: LinearOperator):
        if re_op.shape != im_op.shape:
            raise ValueError("re/im shape mismatch")
        self.re_op = re_op
        self.im_op = im_op

    def tree_flatten(self):
        return (self.re_op, self.im_op), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.re_op.shape

    @property
    def dtype(self):
        return jnp.result_type(self.re_op.dtype, jnp.complex64)

    @property
    def schedule(self):
        return self.re_op.schedule

    # -- split API ---------------------------------------------------------------
    def apply_split(self, xr, xi, *, transpose: bool = False,
                    conj: bool = False):
        """(yr, yi) = op-mode @ (xr + i xi), all arrays real."""
        sign = -1.0 if conj else 1.0
        r = self.re_op
        m = self.im_op
        yr = r._apply(xr, transpose, False) - sign * m._apply(
            xi, transpose, False
        )
        yi = sign * m._apply(xr, transpose, False) + r._apply(
            xi, transpose, False
        )
        return yr, yi

    def mv_split(self, xr, xi):
        return self.apply_split(jnp.asarray(xr), jnp.asarray(xi))

    def mm_split(self, Xr, Xi):
        return self.apply_split(jnp.asarray(Xr), jnp.asarray(Xi))

    # -- complex convenience -----------------------------------------------------
    def _apply(self, x, transpose, conj):
        yr, yi = self.apply_split(
            jnp.real(x), jnp.imag(x), transpose=transpose, conj=conj
        )
        return jax.lax.complex(yr, yi.astype(yr.dtype))

    def __repr__(self):
        return f"ComplexSplitOperator(re={self.re_op!r}, im={self.im_op!r})"
