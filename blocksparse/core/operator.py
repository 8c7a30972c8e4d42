"""Operator algebra layer: the LinearMaps.jl-equivalence surface.

Parity target: the reference's ``AbstractBlockMatrix{T} <: LinearMap{T}``
(src/abstractblockmatrix.jl:13) which inherits ``*``, 5-arg ``mul!``,
``adjoint``/``transpose`` wrapping, multi-RHS products, and operator
composition from LinearMaps.jl.  Here the same algebra is provided natively:

- ``A @ x`` / ``A.mv(x)``        : SpMV
- ``A @ X`` / ``A.mm(X)``        : multi-RHS SpMM (true batched kernel, unlike
                                   the reference's column-wise fallback)
- ``A.axpby(x, y, alpha, beta)`` : functional 5-arg ``mul!`` -> alpha*A@x + beta*y
- ``A.T`` / ``A.H`` / ``A.conj()``: lazy wrappers (flag flips; index tables and
                                   color sets swap roles, mirroring
                                   blockmatrix.jl:154-206)
- ``a * A``, ``A + B``, ``A @ B``: scaled / summed / composed operators

All operators are jax pytrees, so they can be passed through ``jit``,
``grad``, ``shard_map`` and into ``jax.scipy.sparse.linalg`` solvers.

Divergence (deliberate, documented): the 5-arg path follows the strict BLAS
rule that a *static* beta == 0 overwrites y (no NaN propagation), unlike the
reference's ``y .*= beta`` (blockmatrix.jl:231) which propagates NaN.
A traced (non-static) beta multiplies through like the reference.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LinearOperator",
    "AdjointOperator",
    "TransposeOperator",
    "ConjOperator",
    "ScaledOperator",
    "SumOperator",
    "ComposedOperator",
]


@partial(jax.jit, static_argnames=("transpose", "conj"))
def _apply_jit(op, x, *, transpose: bool, conj: bool):
    """Jitted entry for all products.  ``op`` is a pytree argument, so one
    compilation serves every operator with the same structure (layout aux is
    content-hashed; see core/layout.py)."""
    return op._apply(x, transpose, conj)


def _is_static_zero(v) -> bool:
    return isinstance(v, (int, float, complex)) and v == 0


def _is_static_one(v) -> bool:
    return isinstance(v, (int, float, complex)) and v == 1


class LinearOperator:
    """Abstract linear operator with lazy adjoint/transpose and composition."""

    # subclasses must provide: shape -> (m, n), dtype, _apply(x, transpose, conj)

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self):
        raise NotImplementedError

    def _apply(self, x, transpose: bool, conj: bool):
        """Apply the operator (or its transpose/conjugate) to x.

        x: [n] or [n, r].  Returns [m] or [m, r] accordingly.
        """
        raise NotImplementedError

    # -- core products ------------------------------------------------------
    def mv(self, x):
        x = jnp.asarray(x)
        if x.ndim != 1:
            raise ValueError(f"mv expects a vector, got shape {x.shape}")
        if x.shape[0] != self.shape[1]:
            raise ValueError(
                f"operand length {x.shape[0]} != operator ncols {self.shape[1]}"
            )
        return _apply_jit(self, x, transpose=False, conj=False)

    def mm(self, X):
        X = jnp.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"mm expects a matrix, got shape {X.shape}")
        if X.shape[0] != self.shape[1]:
            raise ValueError(
                f"operand rows {X.shape[0]} != operator ncols {self.shape[1]}"
            )
        return _apply_jit(self, X, transpose=False, conj=False)

    def axpby(self, x, y, alpha=1, beta=0):
        """Functional 5-arg mul!: returns alpha * (A @ x) + beta * y.

        Parity: LinearMaps 5-arg ``_unsafe_mul!`` funneled at
        abstractblockmatrix.jl:27-34.  Static beta == 0 overwrites
        (strict BLAS; see module docstring).
        """
        x = jnp.asarray(x)
        if x.shape[0] != self.shape[1]:
            raise ValueError(
                f"operand length {x.shape[0]} != operator ncols {self.shape[1]}"
            )
        ax = _apply_jit(self, x, transpose=False, conj=False)
        if not _is_static_one(alpha):
            ax = alpha * ax
        if _is_static_zero(beta):
            return ax
        return ax + beta * jnp.asarray(y)

    # -- python operator sugar ---------------------------------------------
    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ComposedOperator(self, other)
        other = jnp.asarray(other)
        if other.ndim == 1:
            return self.mv(other)
        if other.ndim == 2:
            return self.mm(other)
        raise ValueError(f"cannot multiply operator by array of ndim {other.ndim}")

    def apply(self, x, *, transpose: bool = False, conj: bool = False):
        """Jitted product with explicit mode flags."""
        return _apply_jit(self, jnp.asarray(x), transpose=transpose, conj=conj)

    def __mul__(self, other):
        if isinstance(other, (int, float, complex)) or (
            hasattr(other, "ndim") and getattr(other, "ndim", None) == 0
        ):
            return ScaledOperator(other, self)
        return self.__matmul__(other)

    def __rmul__(self, other):
        if isinstance(other, (int, float, complex)) or (
            hasattr(other, "ndim") and getattr(other, "ndim", None) == 0
        ):
            return ScaledOperator(other, self)
        return NotImplemented

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator(self, other)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator(self, ScaledOperator(-1, other))
        return NotImplemented

    def __neg__(self):
        return ScaledOperator(-1, self)

    # -- lazy wrappers ------------------------------------------------------
    @property
    def T(self) -> "LinearOperator":
        return TransposeOperator(self)

    @property
    def H(self) -> "LinearOperator":
        return AdjointOperator(self)

    def adjoint(self) -> "LinearOperator":
        return self.H

    def transpose(self) -> "LinearOperator":
        return self.T

    def conj(self) -> "LinearOperator":
        return ConjOperator(self)

    # -- split-complex form ----------------------------------------------------
    def split(self):
        """Split-real form: a ComplexSplitOperator over two real operators.

        Four real products per complex product, each on the real engines;
        ``mv_split``/``mm_split`` take and return (re, im) pairs of real
        arrays.  Complex operators also run natively (``A @ x``); the split
        form is there for callers that keep re/im planes apart.  Only
        format operators with complex dtype support this."""
        from ..complexops import autosplit

        return autosplit(self)

    def mv_split(self, xr, xi):
        return self.split().mv_split(xr, xi)

    def mm_split(self, Xr, Xi):
        return self.split().mm_split(Xr, Xi)

    # -- materialization ----------------------------------------------------
    def todense(self) -> np.ndarray:
        """Materialize as a dense array (parity: ``A[:, :]``, test usage)."""
        n = self.shape[1]
        eye = jnp.eye(n, dtype=self.dtype)
        return np.asarray(self.mm(eye))

    def matvec_closure(self):
        """A plain ``x -> A @ x`` callable for jax.scipy.sparse.linalg."""
        return lambda x: self.__matmul__(x)


class _WrappedOperator(LinearOperator):
    """Base for single-child lazy wrappers; child is the sole pytree leaf."""

    def __init__(self, op: LinearOperator):
        self.op = op

    def tree_flatten(self):
        return (self.op,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def schedule(self):
        """Forwarded accessor (parity: ``scheduler(A')``,
        abstractblockmatrix.jl:50-62)."""
        return self.op.schedule


@jax.tree_util.register_pytree_node_class
class TransposeOperator(_WrappedOperator):
    """Lazy transpose (parity: LinearMaps.TransposeMap wrapping)."""

    @property
    def shape(self):
        m, n = self.op.shape
        return (n, m)

    def _apply(self, x, transpose, conj):
        return self.op._apply(x, not transpose, conj)

    @property
    def T(self):
        return self.op

    @property
    def H(self):
        return ConjOperator(self.op)


@jax.tree_util.register_pytree_node_class
class AdjointOperator(_WrappedOperator):
    """Lazy adjoint (parity: LinearMaps.AdjointMap wrapping)."""

    @property
    def shape(self):
        m, n = self.op.shape
        return (n, m)

    def _apply(self, x, transpose, conj):
        return self.op._apply(x, not transpose, not conj)

    @property
    def H(self):
        return self.op

    @property
    def T(self):
        return ConjOperator(self.op)


@jax.tree_util.register_pytree_node_class
class ConjOperator(_WrappedOperator):
    """Lazy elementwise conjugate: conj(A) = (A.H).T."""

    @property
    def shape(self):
        return self.op.shape

    def _apply(self, x, transpose, conj):
        return self.op._apply(x, transpose, not conj)

    def conj(self):
        return self.op


@jax.tree_util.register_pytree_node_class
class ScaledOperator(LinearOperator):
    """alpha * A (parity: LinearMaps scalar composition)."""

    def __init__(self, alpha, op: LinearOperator):
        self.alpha = alpha
        self.op = op

    def tree_flatten(self):
        return (self.alpha, self.op), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1])

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return jnp.result_type(self.op.dtype, jnp.asarray(self.alpha).dtype)

    def _apply(self, x, transpose, conj):
        a = jnp.conj(self.alpha) if conj else self.alpha
        return a * self.op._apply(x, transpose, conj)


@jax.tree_util.register_pytree_node_class
class SumOperator(LinearOperator):
    """A + B."""

    def __init__(self, a: LinearOperator, b: LinearOperator):
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
        self.a = a
        self.b = b

    def tree_flatten(self):
        return (self.a, self.b), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return jnp.result_type(self.a.dtype, self.b.dtype)

    def _apply(self, x, transpose, conj):
        return self.a._apply(x, transpose, conj) + self.b._apply(x, transpose, conj)


@jax.tree_util.register_pytree_node_class
class ComposedOperator(LinearOperator):
    """A @ B (parity: LinearMaps operator composition)."""

    def __init__(self, a: LinearOperator, b: LinearOperator):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"inner dim mismatch: {a.shape} @ {b.shape}")
        self.a = a
        self.b = b

    def tree_flatten(self):
        return (self.a, self.b), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return (self.a.shape[0], self.b.shape[1])

    @property
    def dtype(self):
        return jnp.result_type(self.a.dtype, self.b.dtype)

    def _apply(self, x, transpose, conj):
        if transpose:
            # (A B)^T = B^T A^T
            return self.b._apply(self.a._apply(x, True, conj), True, conj)
        return self.a._apply(self.b._apply(x, False, conj), False, conj)
