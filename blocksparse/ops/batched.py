"""Batched multi-operand products: ``[ops[p] @ Xs[p] for p]``.

Workloads with many right-hand-side *operators* -- e.g. frequency sweeps
over BEM systems with one near-field structure -- apply P operators to P
operands.  The reference has no batched-product concept (independent
products go through separate LinearMaps calls).  Here the products run as
a per-operator loop through each operator's normal path; a stacked form
(one index table, P value sets through one contraction) is not written
yet.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["batched_mm", "batched_mv"]


def _stack(name, ops, xs, ndim):
    ops = list(ops)
    if isinstance(xs, (list, tuple)):
        xs = jnp.stack([jnp.asarray(x) for x in xs])
    xs = jnp.asarray(xs)
    if xs.shape[0] != len(ops):
        raise ValueError(
            f"{name}: {len(ops)} operators but the operand has leading dim "
            f"{xs.shape[0]}")
    if xs.ndim != ndim:
        raise ValueError(
            f"{name} expects operands of shape "
            f"{'[P, n]' if ndim == 2 else '[P, n, r]'}")
    return ops, xs


def batched_mv(ops, xs):
    """``[ops[p] @ xs[p] for p]``.  ``xs``: [P, n] array or list of [n].
    Returns [P, m].  Differentiable in ``xs`` and in each operator's
    values."""
    ops, xs = _stack("batched_mv", ops, xs, 2)
    return jnp.stack([op @ xs[p] for p, op in enumerate(ops)])


def batched_mm(ops, Xs):
    """``[ops[p] @ Xs[p] for p]``.  ``Xs``: [P, n, r] array or a list of
    [n, r].  Returns [P, m, r].  Differentiable in ``Xs`` and in each
    operator's values."""
    ops, Xs = _stack("batched_mm", ops, Xs, 3)
    return jnp.stack([op @ Xs[p] for p, op in enumerate(ops)])
