"""Iterative solvers over the block-sparse operator algebra.

The reference gets iterative solvers for free by being a ``LinearMap``
(src/abstractblockmatrix.jl:13 -- any LinearMaps-compatible
Krylov package consumes it).  Here the analog is twofold:

- every :class:`~blocksparse.core.operator.LinearOperator` already plugs
  into ``jax.scipy.sparse.linalg`` via ``A.matvec_closure()``;
- this module adds first-class, jit-compilable solvers that accept the
  operators *directly*, support left preconditioning (itself any operator,
  callable, or dense array), and -- unlike ``jax.scipy`` -- report iteration
  count, final residual, and convergence status (``jax.scipy`` returns
  ``info=None`` unconditionally).

All solvers are pure ``lax.while_loop`` programs: static shapes, no
data-dependent Python control flow, so they compile once under ``jit`` and
run on the device end to end (the block SpMV *is* the loop body's hot op).
Works on the CPU backend in f64/c128 at reference tolerances and on the GPU
in any of float32/complex64/float64/complex128.

Complex support: CG uses the standard complex-Hermitian recurrences
(``vdot`` inner products); BiCGStab uses the unconjugated shadow-residual
bilinear form, matching textbook/SciPy behavior.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .core.operator import LinearOperator

# The Krylov basis products keep full precision: a float32 matmul left to
# the backend's default may run in TF32 on a GPU (~1e-3), which would cost
# the basis its orthogonality.
_dot = partial(jnp.matmul, precision=lax.Precision.HIGHEST)

__all__ = ["SolveInfo", "cg", "bicgstab", "gmres", "as_matvec"]


class SolveInfo(NamedTuple):
    """Outcome of an iterative solve (all fields are jax scalars)."""

    iterations: jax.Array  # int32 number of iterations performed
    residual: jax.Array  # final ||b - A x|| (true residual for cg/bicgstab)
    converged: jax.Array  # bool: residual <= max(tol*||b||, atol)


def as_matvec(A) -> Callable:
    """Normalize an operator-like object to an ``x -> A @ x`` callable.

    Accepts a :class:`LinearOperator` (or any of its lazy wrappers /
    distributed counterparts), a callable, or a dense matrix.
    """
    if isinstance(A, LinearOperator):
        return lambda x: A.apply(x)
    if callable(A) and not hasattr(A, "ndim"):
        return A
    arr = jnp.asarray(A)
    return lambda x: _dot(arr, x)


def _as_precond(M) -> Callable:
    if M is None:
        return lambda x: x
    return as_matvec(M)


def _tolerance(b, tol, atol):
    bnorm = jnp.linalg.norm(b)
    return jnp.maximum(tol * bnorm, atol).astype(jnp.real(b).dtype)


def cg(A, b, *, x0=None, tol=1e-6, atol=0.0, maxiter=None, M=None):
    """Preconditioned conjugate gradients for Hermitian positive-definite A.

    Returns ``(x, SolveInfo)``.  ``M`` is a left preconditioner approximating
    ``A^{-1}`` (operator, callable, or dense array).  jit-compatible.
    """
    mv, pre = as_matvec(A), _as_precond(M)
    b = jnp.asarray(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    thresh = _tolerance(b, tol, atol)

    r0 = b - mv(x)
    z0 = pre(r0)
    # state: (k, x, r, z, p, rz)
    state = (jnp.int32(0), x, r0, z0, z0, jnp.vdot(r0, z0))

    def cond(s):
        k, _, r, *_ = s
        return (k < maxiter) & (jnp.linalg.norm(r) > thresh)

    def body(s):
        k, x, r, z, p, rz = s
        ap = mv(p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = pre(r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (k + 1, x, r, z, p, rz_new)

    k, x, r, *_ = lax.while_loop(cond, body, state)
    res = jnp.linalg.norm(b - mv(x))
    return x, SolveInfo(k, res, res <= thresh)


def bicgstab(A, b, *, x0=None, tol=1e-6, atol=0.0, maxiter=None, M=None):
    """Preconditioned BiCGStab for general (non-symmetric) square A.

    Returns ``(x, SolveInfo)``.  jit-compatible; breaks down gracefully
    (rho or omega ~ 0 stalls the iteration, leaving the best x so far,
    reported via ``converged``).
    """
    mv, pre = as_matvec(A), _as_precond(M)
    b = jnp.asarray(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    thresh = _tolerance(b, tol, atol)

    r0 = b - mv(x)
    rhat = r0  # shadow residual, fixed
    one = jnp.ones((), b.dtype)
    # state: (k, x, r, p, v, rho, alpha, omega, stalled)
    state = (jnp.int32(0), x, r0, jnp.zeros_like(b), jnp.zeros_like(b),
             one, one, one, jnp.bool_(False))
    eps = jnp.finfo(jnp.real(b).dtype).tiny * 16

    def cond(s):
        k, _, r, *_, stalled = s
        return (k < maxiter) & (jnp.linalg.norm(r) > thresh) & (~stalled)

    def body(s):
        k, x, r, p, v, rho, alpha, omega, _ = s
        rho_new = jnp.vdot(rhat, r)
        stalled = (jnp.abs(rho_new) < eps) | (jnp.abs(omega) < eps)
        # guard the divisions so a breakdown never pollutes the iterate;
        # when stalled the old state is kept and the loop exits next cond.
        safe = lambda d: jnp.where(stalled, jnp.ones((), d.dtype), d)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p_new = r + beta * (p - omega * v)
        phat = pre(p_new)
        v_new = mv(phat)
        alpha_new = rho_new / safe(jnp.vdot(rhat, v_new))
        sres = r - alpha_new * v_new
        shat = pre(sres)
        t = mv(shat)
        omega_new = jnp.vdot(t, sres) / safe(jnp.vdot(t, t))
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = sres - omega_new * t
        keep = lambda old, new: jnp.where(stalled, old, new)
        return (
            k + 1,
            keep(x, x_new),
            keep(r, r_new),
            keep(p, p_new),
            keep(v, v_new),
            keep(rho, rho_new),
            keep(alpha, alpha_new),
            keep(omega, omega_new),
            stalled,
        )

    k, x, r, *_ = lax.while_loop(cond, body, state)
    res = jnp.linalg.norm(b - mv(x))
    return x, SolveInfo(k, res, res <= thresh)


def gmres(A, b, *, x0=None, tol=1e-6, atol=0.0, restart=20, maxiter=None,
          M=None):
    """Restarted GMRES(m): native Arnoldi + Givens implementation.

    A full ``lax.while_loop`` program (no delegation): per restart cycle the
    Krylov basis is built with classical Gram-Schmidt with one
    reorthogonalization pass (CGS2 -- two [m, n] matmuls per step, the
    accelerator-friendly equivalent of modified Gram-Schmidt's n sequential
    axpys), the Hessenberg column is rotated into triangular form with
    Givens rotations so the residual norm is tracked for free, and the inner
    loop exits early on convergence or lucky breakdown.

    ``M`` is a LEFT preconditioner approximating ``A^{-1}``: the iteration
    runs on ``M A x = M b`` and converges when the *preconditioned* residual
    meets ``max(tol * ||M b||, atol)`` (SciPy semantics).  The returned
    ``SolveInfo`` reports the TRUE residual ``||b - A x||`` and the number
    of inner (matvec) iterations actually performed; ``converged`` reflects
    the preconditioned test.  Works for real and complex dtypes;
    jit-compatible (static shapes: the basis buffer is [restart+1, n]).

    Returns ``(x, SolveInfo)``.
    """
    mv, pre = as_matvec(A), _as_precond(M)
    b = jnp.asarray(b)
    n = b.shape[0]
    m = int(min(restart, n))
    if maxiter is None:
        maxiter = 10 * n
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).astype(b.dtype)
    rdt = jnp.real(b).dtype
    pb = pre(b)
    thresh = jnp.maximum(tol * jnp.linalg.norm(pb), atol).astype(rdt)
    eps = jnp.finfo(rdt).eps

    def cycle(carry):
        it, x, _resnorm, done = carry
        r = pre(b - mv(x))
        beta = jnp.linalg.norm(r).astype(rdt)
        V = jnp.zeros((m + 1, n), b.dtype)
        V = V.at[0].set(jnp.where(beta > 0, r / beta.astype(b.dtype), r))
        H = jnp.zeros((m + 1, m), b.dtype)   # rotated (triangular) columns
        cs = jnp.zeros((m,), b.dtype)
        sn = jnp.zeros((m,), b.dtype)
        g = jnp.zeros((m + 1,), b.dtype).at[0].set(beta.astype(b.dtype))

        def inner_cond(s):
            j, *_ , res, brk = s
            return (j < m) & (res > thresh) & (~brk) & (it + j < maxiter)

        def inner_body(s):
            j, V, H, cs, sn, g, _res, _brk = s
            w = pre(mv(V[j]))
            # CGS2: rows > j of V are zero, so the full-matrix projections
            # are exact and need no masking
            h1 = _dot(jnp.conj(V), w)
            w = w - _dot(V.T, h1)
            h2 = _dot(jnp.conj(V), w)
            w = w - _dot(V.T, h2)
            h = h1 + h2
            hnorm = jnp.linalg.norm(w).astype(rdt)
            # lucky breakdown: the Krylov space is invariant; finish this
            # column (its rotation is trivial) and exit the cycle
            brk = hnorm <= eps * 100 * (jnp.linalg.norm(h).astype(rdt) + 1)
            V = V.at[j + 1].set(jnp.where(
                brk, jnp.zeros_like(w),
                w / jnp.where(brk, 1.0, hnorm).astype(b.dtype)))
            h = h.at[j + 1].set(jnp.where(brk, 0.0, hnorm).astype(b.dtype))

            # apply the previous rotations to the new column
            def rot(i, hv):
                hi = cs[i] * hv[i] + sn[i] * hv[i + 1]
                hj = -jnp.conj(sn[i]) * hv[i] + jnp.conj(cs[i]) * hv[i + 1]
                return hv.at[i].set(jnp.where(i < j, hi, hv[i])).at[i + 1].set(
                    jnp.where(i < j, hj, hv[i + 1]))

            h = lax.fori_loop(0, m, rot, h)
            # new rotation zeroing h[j+1]
            a_, b_ = h[j], h[j + 1]
            denom = jnp.sqrt(jnp.abs(a_) ** 2 + jnp.abs(b_) ** 2)
            safe = jnp.where(denom > 0, denom, 1.0).astype(rdt)
            c_new = (jnp.abs(a_) / safe).astype(b.dtype)
            phase = jnp.where(jnp.abs(a_) > 0, a_ / jnp.abs(a_).astype(b.dtype),
                              jnp.ones((), b.dtype))
            s_new = phase * jnp.conj(b_) / safe.astype(b.dtype)
            h = h.at[j].set(c_new * a_ + s_new * b_).at[j + 1].set(0)
            H = H.at[:, j].set(h)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-jnp.conj(s_new) * gj)
            res = jnp.abs(g[j + 1]).astype(rdt)
            return (j + 1, V, H, cs, sn, g, res, brk)

        j_end, V, H, cs, sn, g, res, _brk = lax.while_loop(
            inner_cond, inner_body,
            (jnp.int32(0), V, H, cs, sn, g, beta, jnp.bool_(False)))

        # back-substitution on the rotated (triangular) H: pad unused rows
        # with an identity diagonal so y[j_end:] = 0
        idx = jnp.arange(m)
        used = idx < j_end
        R = H[:m, :m]
        R = jnp.where(used[:, None] & used[None, :], R,
                      jnp.eye(m, dtype=b.dtype))
        rhs = jnp.where(used, g[:m], jnp.zeros_like(g[:m]))
        y = jax.scipy.linalg.solve_triangular(R, rhs, lower=False)
        x = x + _dot(V[:m].T, y)
        done = res <= thresh
        return (it + j_end, x, res, done)

    def outer_cond(c):
        it, _x, _res, done = c
        return (it < maxiter) & (~done)

    it, x, _res, done = lax.while_loop(
        outer_cond, cycle,
        (jnp.int32(0), x, jnp.array(jnp.inf, rdt), jnp.bool_(False)))
    res_true = jnp.linalg.norm(b - mv(x))
    return x, SolveInfo(it, res_true, done)
