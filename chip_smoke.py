#!/usr/bin/env python
"""On-card smoke test: the library's main path on one GPU, at real size.

    python chip_smoke.py              # phases 0-5 on one card
    python chip_smoke.py --cards 4    # only the distributed phase, 4 cards

Builds the near-field operator of a boundary-element problem (points on a
sphere, leaf clusters of ~64 points, ~30 near neighbours per leaf, a 1/r and
a Helmholtz exp(ikr)/(4 pi r) kernel) in the library's three formats, runs
the products, a preconditioned GMRES solve and the ``gpu`` test tier through
the normal entry points, and compares every result with the scipy oracle
(``bst.to_scipy``) in float64 on the host.

Phases:
  0  device, JAX version, compile cache, card name and power limit
  1  operators: (a) SymmetricBlockMatrix complex64, sorted non-contiguous
     index lists; (b) the same near field leaf-sorted into VBCRS, float32;
     (c) BlockSparseMatrix float32, both halves stored, lists as in (a)
  2  A@x, A@X (r = 64, 128), A.T@x, A.H@x, axpby on (a)-(c); one float64
     operator; jax.grad through A@X
  3  GMRES with block-Jacobi on (a)
  4  no hand-written kernel is on the path; the colored gather rounds
     against scatter-add on (a), timed
  5  the tests marked ``gpu``, in this process
  6  (--cards N only) parallel.distribute of (a) and (c) over N cards

Any failed check raises: the script then exits non-zero and prints no ok
line.  The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# max |error| / max |oracle| bounds (float32 / complex64 at
# precision="highest": a row sums ~2,000 products; float64 likewise)
TOL32 = 1e-5
TOL64 = 1e-12
LEAF = 64          # points per leaf cluster at most
# GMRES: stop at this preconditioned relative residual, then require the
# true relative residual (oracle, float64) below the second bound
GMRES_TOL = 1e-6
GMRES_CHECK = 1e-4


class SmokeFailure(AssertionError):
    """A result out of tolerance, of the wrong shape, or not finite."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card(s), read by a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


# -- comparisons --------------------------------------------------------------


def rel_err(y, ref) -> float:
    """max |y - ref| / max |ref|, in float64/complex128."""
    y = np.asarray(y)
    ref = np.asarray(ref)
    if y.shape != ref.shape:
        raise SmokeFailure(f"shape {y.shape} != oracle shape {ref.shape}")
    if not np.all(np.isfinite(y)):
        raise SmokeFailure("result holds non-finite values")
    dt = np.complex128 if np.iscomplexobj(y) or np.iscomplexobj(ref) \
        else np.float64
    y, ref = y.astype(dt), ref.astype(dt)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    return float(np.max(np.abs(y - ref))) / (scale or 1.0)


def check(name: str, y, ref, tol: float) -> float:
    err = rel_err(y, ref)
    ok = err <= tol
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: rel err {err:.3e} "
        f"(bound {tol:.0e})")
    if not ok:
        raise SmokeFailure(f"{name}: rel err {err:.3e} > {tol:.0e}")
    return err


def report(name: str, y, ref) -> float:
    """An error printed without a bound (reduced-precision tiers)."""
    err = rel_err(y, ref)
    log(f"  info {name}: rel err {err:.3e} (not bounded)")
    return err


def oracle_mm(S, X, threads: int = 16):
    """S @ X in the oracle's precision, split over column blocks."""
    from concurrent.futures import ThreadPoolExecutor

    X = np.asarray(X)
    if X.ndim == 1 or X.shape[1] <= 8:
        return S @ X
    parts = np.array_split(np.arange(X.shape[1]), min(threads, X.shape[1]))
    with ThreadPoolExecutor(len(parts)) as pool:
        cols = list(pool.map(lambda p: S @ X[:, p], parts))
    return np.concatenate(cols, axis=1)


# -- the boundary-element near field ----------------------------------------


def sphere_points(n: int, seed: int) -> np.ndarray:
    """Fibonacci points on the unit sphere, jittered from ``seed``."""
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1 - 2 * (i + 0.5) / n
    rho = np.sqrt(1 - z * z)
    p = np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)
    p += 0.1 * np.sqrt(4 * np.pi / n) * \
        np.random.default_rng(seed).standard_normal(p.shape)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def leaf_clusters(pts: np.ndarray, leaf: int) -> list[np.ndarray]:
    """Recursive median bisection along the widest extent into leaves of at
    most ``leaf`` points.  Point ids are not renumbered: each leaf is a
    sorted, in general non-contiguous, list of ids."""
    out = []
    stack = [np.arange(len(pts))]
    while stack:
        ids = stack.pop()
        if len(ids) <= leaf:
            out.append(np.sort(ids))
            continue
        ax = int(np.argmax(np.ptp(pts[ids], axis=0)))
        order = ids[np.argsort(pts[ids, ax], kind="stable")]
        h = len(order) // 2
        stack += [order[h:], order[:h]]
    return out


def near_pairs(centers: np.ndarray, near: int) -> np.ndarray:
    """Symmetric near-field leaf pairs (i <= j): each leaf with its
    ``near`` nearest leaves (itself included), symmetrised."""
    from scipy.spatial import cKDTree

    _, nb = cKDTree(centers).query(centers, k=min(near, len(centers)))
    i = np.repeat(np.arange(len(centers)), nb.shape[1])
    j = nb.ravel()
    pairs = np.unique(np.stack([np.minimum(i, j), np.maximum(i, j)], 1),
                      axis=0)
    return pairs


def kernel_block(pts, ri, ci, kappa: float | None):
    """1/(4 pi r) (kappa None) or exp(i kappa r)/(4 pi r) between two
    leaves; coincident points get the leaf size on the diagonal."""
    d = np.linalg.norm(pts[ri][:, None, :] - pts[ci][None, :, :], axis=-1)
    same = ri[:, None] == ci[None, :]
    d = np.where(same, 1.0, d)
    g = (1.0 if kappa is None else np.exp(1j * kappa * d)) / (4 * np.pi * d)
    return np.where(same, float(len(ri)), g)


def near_field(n: int, leaf: int, near: int, seed: int):
    """Points, leaves, near pairs and the Helmholtz wavenumber."""
    pts = sphere_points(n, seed)
    leaves = leaf_clusters(pts, leaf)
    centers = np.stack([pts[c].mean(axis=0) for c in leaves])
    pairs = near_pairs(centers, near)
    h = np.sqrt(4 * np.pi / n)
    kappa = 2 * np.pi / (10 * h)          # ten points per wavelength
    return pts, leaves, pairs, kappa


def build_operators(n: int, leaf: int, near: int, seed: int, dtype64=False):
    """Operators (a), (b), (c) of the module docstring, plus set-up
    times.  ``dtype64`` builds (c) alone, in float64."""
    import blocksparse as bst

    t0 = time.perf_counter()
    pts, leaves, pairs, kappa = near_field(n, leaf, near, seed)
    ops, times = {}, {}
    if dtype64:
        blocks, rows, cols = [], [], []
        for i, j in pairs:
            b = kernel_block(pts, leaves[i], leaves[j], None)
            blocks.append(b)
            rows.append(leaves[i])
            cols.append(leaves[j])
            if i != j:
                blocks.append(b.T)
                rows.append(leaves[j])
                cols.append(leaves[i])
        ops["c64"] = bst.BlockSparseMatrix(blocks, rows, cols, (n, n))
        times["c64"] = time.perf_counter() - t0
        return ops, times

    # (a) complex symmetric, original point order
    diag, didx, off, ri, ci = [], [], [], [], []
    for i, j in pairs:
        b = kernel_block(pts, leaves[i], leaves[j], kappa).astype(np.complex64)
        if i == j:
            diag.append(b)
            didx.append(leaves[i])
        else:
            off.append(b)
            ri.append(leaves[i])
            ci.append(leaves[j])
    t1 = time.perf_counter()
    ops["a"] = bst.SymmetricBlockMatrix(diag, didx, off, ri, ci, (n, n))
    times["a"] = time.perf_counter() - t1 + (t1 - t0)

    # (c) general float32, both halves, original order; (b) the same blocks
    # leaf-sorted: leaf k occupies the contiguous range starting at start[k]
    t2 = time.perf_counter()
    start = np.cumsum([0] + [len(c) for c in leaves])
    blocks, rows, cols, rs, cs = [], [], [], [], []
    for i, j in pairs:
        b = kernel_block(pts, leaves[i], leaves[j], None).astype(np.float32)
        for (p, q, v) in ((i, j, b),) + (((j, i, b.T),) if i != j else ()):
            blocks.append(np.ascontiguousarray(v))
            rows.append(leaves[p])
            cols.append(leaves[q])
            rs.append(int(start[p]))
            cs.append(int(start[q]))
    t3 = time.perf_counter()
    ops["c"] = bst.BlockSparseMatrix(blocks, rows, cols, (n, n))
    times["c"] = time.perf_counter() - t3 + (t3 - t2)
    t4 = time.perf_counter()
    ops["b"] = bst.VariableBlockCompressedRowStorage(blocks, rs, cs, (n, n))
    times["b"] = time.perf_counter() - t4 + (t3 - t2)
    return ops, times


def value_bytes(A) -> int:
    """Bytes of stored (padded) block values on the device."""
    lays = [A._dlayout, A._olayout] if hasattr(A, "_dlayout") else [A.layout]
    return sum(b.values.nbytes for lay in lays for b in lay.buckets)


def nblocks(A) -> int:
    if hasattr(A, "_dlayout"):
        return A.ndiagonals + A.noffdiagonals
    return A.nblocks


def oracle_of(A):
    """The scipy oracle in float64 (complex128 for complex operators)."""
    import blocksparse as bst

    S = bst.to_scipy(A).tocsr()
    return S.astype(np.complex128 if np.iscomplexobj(S.data) else np.float64)


def with_precision(A, precision):
    B = copy.copy(A)
    B._precision = precision
    return B


# -- phases ---------------------------------------------------------------------


def rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def phase_products(label, A, S, rng, *, tol, rs=(64, 128)):
    """Phase 2 on one operator: every product against the oracle."""
    import jax

    m, n = A.shape
    dt = np.dtype(A.dtype)
    x = rand(rng, n, dt)
    yv = rand(rng, m, dt)
    mv = jax.jit(lambda A, v: A @ v)
    check(f"{label} A@x", mv(A, x), S @ x, tol)
    for r in rs:
        X = rand(rng, (n, r), dt)
        check(f"{label} A@X r={r}", mv(A, X), oracle_mm(S, X), tol)
    xt = rand(rng, m, dt)
    check(f"{label} A.T@x", jax.jit(lambda A, v: A.T @ v)(A, xt),
          S.T @ xt, tol)
    check(f"{label} A.H@x", jax.jit(lambda A, v: A.H @ v)(A, xt),
          S.conj().T @ xt, tol)
    alpha, beta = 0.75 - 0.5j, -0.25 + 1.5j
    ax = jax.jit(lambda A, v, w: A.axpby(v, w, alpha, beta))(A, x, yv)
    check(f"{label} axpby", ax, alpha * (S @ x) + beta * yv, tol)


def phase_grad(label, A, S, rng, r=64):
    import jax
    import jax.numpy as jnp

    n = A.shape[1]
    X = rand(rng, (n, r), np.float32)
    W = rand(rng, (A.shape[0], r), np.float32)
    # A and W are arguments, not constants folded into the program
    g = jax.jit(jax.grad(lambda X, A, W: jnp.sum(W * (A @ X))))(X, A, W)
    check(f"{label} grad_X sum(W*(A@X)) r={r}", g, oracle_mm(S.T, W), TOL32)


def phase_solve(A, S, rng):
    import jax

    import blocksparse as bst
    from blocksparse.utils.timing import time_fn

    n = A.shape[0]
    b = rand(rng, n, np.dtype(A.dtype))
    t0 = time.perf_counter()
    M = bst.block_jacobi(A)
    log(f"  block_jacobi set-up {time.perf_counter() - t0:.2f} s")
    solve = jax.jit(lambda A, M, b: bst.gmres(A, b, tol=GMRES_TOL, restart=30,
                                              maxiter=3000, M=M))
    x, info = solve(A, M, b)
    t = time_fn(solve, A, M, b, warmup=0, samples=5)
    res = float(np.linalg.norm(b - S @ np.asarray(x)) / np.linalg.norm(b))
    log(f"  gmres(restart=30, tol={GMRES_TOL:.0e}) + block_jacobi: "
        f"{int(info.iterations)} iterations, converged={bool(info.converged)}, "
        f"time to solution median {t['median']*1e3:.2f} ms "
        f"(p10 {t['p10']*1e3:.2f}, p90 {t['p90']*1e3:.2f}, n={t['n']})")
    if not bool(info.converged):
        raise SmokeFailure("gmres did not converge")
    ok = res <= GMRES_CHECK
    log(f"  {'ok  ' if ok else 'FAIL'} true relative residual (oracle) "
        f"{res:.3e} (bound {GMRES_CHECK:.0e})")
    if not ok:
        raise SmokeFailure(f"gmres true residual {res:.3e}")


def fmt_t(t) -> str:
    return (f"median {t['median']*1e3:.4f} ms (p10 {t['p10']*1e3:.4f}, "
            f"p90 {t['p90']*1e3:.4f}, n={t['n']})")


def phase_colored(A, rng, samples=30):
    """Colored gather rounds against scatter-add on (a), same operator."""
    import jax

    from blocksparse.utils.timing import time_fn

    x = rand(rng, A.shape[1], np.dtype(A.dtype))
    outs = {}
    for mode in ("always", "never"):
        os.environ["BST_COLORED"] = mode
        try:
            # a fresh jit traces anew and so reads the setting
            f = jax.jit(lambda A, v: A._apply(v, False, False))
            outs[mode] = (f(A, x), time_fn(f, A, x, samples=samples))
        finally:
            del os.environ["BST_COLORED"]
    check("a colored vs scatter-add", outs["always"][0], outs["never"][0],
          TOL32)
    log(f"  a A@x colored rounds {fmt_t(outs['always'][1])} | scatter-add "
        f"{fmt_t(outs['never'][1])}")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    if rc != 0:
        raise SmokeFailure(f"gpu test tier failed (pytest exit {int(rc)})")


def smoke(opts, card: str) -> None:
    """Phases 1-5 (the script runs phase 0 and the device check)."""
    import jax

    rng = np.random.default_rng(opts.seed)
    log(f"# phase 1: operators (n={opts.points}, leaf={LEAF}, "
        f"near={opts.near})")
    ops, times = build_operators(opts.points, LEAF, opts.near, opts.seed)
    oracles = {}
    for k in ("a", "b", "c"):
        A = ops[k]
        t0 = time.perf_counter()
        oracles[k] = oracle_of(A)
        log(f"  ({k}) {A}: {nblocks(A)} blocks, "
            f"{value_bytes(A) / 1e6:.1f} MB of block values, set-up "
            f"{times[k]:.1f} s, oracle {time.perf_counter() - t0:.1f} s")
        if value_bytes(A) < opts.min_bytes:
            raise SmokeFailure(
                f"({k}) holds {value_bytes(A)} B < {opts.min_bytes} B")

    log("# phase 2: products against the oracle")
    for k in ("a", "b", "c"):
        phase_products(f"({k})", ops[k], oracles[k], rng, tol=TOL32)
    c = ops["c"]
    X = rand(rng, (c.shape[1], 64), np.float32)
    ref = oracle_mm(oracles["c"], X)
    for p in (None, "high"):
        report(f"(c) A@X r=64 precision={p}",
               jax.jit(lambda A, X: A @ X)(with_precision(c, p), X), ref)
    phase_grad("(b)", ops["b"], oracles["b"], rng)
    ops64, t64 = build_operators(opts.points, LEAF, opts.near, opts.seed,
                                 dtype64=True)
    A64 = ops64["c64"]
    log(f"  (c, float64) {A64}: {value_bytes(A64) / 1e6:.1f} MB, set-up "
        f"{t64['c64']:.1f} s")
    phase_products("(c, float64)", A64, oracle_of(A64), rng, tol=TOL64,
                   rs=(64,))
    del ops64, A64

    log("# phase 3: GMRES on (a)")
    phase_solve(ops["a"], oracles["a"], rng)

    log(f"# phase 4: no hand-written kernel; colored rounds vs scatter-add "
        f"on (a), card {card}")
    phase_colored(ops["a"], rng, samples=opts.samples)

    log("# phase 5: gpu test tier")
    phase_gpu_tests()


def phase_cards(opts, ncards: int) -> None:
    """Phase 6: distributed products over ``ncards`` against one card."""
    import jax
    from jax.sharding import Mesh

    from blocksparse.parallel.distributed import distribute

    devs = jax.devices()
    if len(devs) < ncards:
        raise SmokeFailure(f"--cards {ncards} but JAX sees {len(devs)}")
    rng = np.random.default_rng(opts.seed)
    ops, _ = build_operators(opts.points, LEAF, opts.near, opts.seed)
    mesh = Mesh(np.array(devs[:ncards]), ("rows",))
    mesh2 = Mesh(np.array(devs[:ncards]).reshape(ncards // 2, 2),
                 ("rows", "rhs"))
    mv = jax.jit(lambda A, v: A @ v)
    for k in ("a", "c"):
        A = ops[k]
        D = distribute(A, mesh)
        log(f"  ({k}) over {ncards} cards: halo "
            f"{D.exchanged_bytes_per_call / ncards:.0f} B per shard per "
            f"product (r=1, 4-byte words)")
        dt = np.dtype(A.dtype)
        x = rand(rng, A.shape[1], dt)
        X = rand(rng, (A.shape[1], 64), dt)
        check(f"({k}) mesh mv", mv(D, x), mv(A, x), TOL32)
        check(f"({k}) mesh mm r=64", mv(D, X), mv(A, X), TOL32)
        check(f"({k}) mesh .T", jax.jit(lambda D, v: D.T @ v)(D, x),
              jax.jit(lambda A, v: A.T @ v)(A, x), TOL32)
        check(f"({k}) mesh .H", jax.jit(lambda D, v: D.H @ v)(D, x),
              jax.jit(lambda A, v: A.H @ v)(A, x), TOL32)
        D2 = distribute(A, mesh2, rhs_axis="rhs")
        check(f"({k}) 2-D mesh mm r=64", mv(D2, X), mv(A, X), TOL32)
        hlo = jax.jit(lambda D, v: D @ v).lower(D, x).compile().as_text()
        lines = hlo.splitlines()
        starts = [i for i, l in enumerate(lines)
                  if "collective-permute-start" in l]
        dones = [i for i, l in enumerate(lines)
                 if "collective-permute-done" in l]
        inside = 0
        for s in starts:
            d = min((j for j in dones if j > s), default=None)
            if d is not None:
                inside += sum(("fusion" in l or " dot(" in l
                               or "custom-call" in l)
                              for l in lines[s + 1:d])
        log(f"  ({k}) compiled HLO: {len(starts)} collective-permute-start /"
            f" {len(dones)} done; {inside} compute ops scheduled between a "
            f"start and its done; overlap "
            f"{'kept' if starts and inside else 'not found'}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="run only the distributed phase over this many "
                         "cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=65000)
    ap.add_argument("--near", type=int, default=30)
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--min-bytes", type=int, default=200_000_000,
                    help="least block-value bytes per operator")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse_args(argv)
    import jax

    jax.config.update("jax_enable_x64", True)   # before the first array
    sys.path.insert(0, ROOT)
    from blocksparse.utils.compile_cache import use_checkout_cache

    cache = use_checkout_cache(ROOT)
    dev = jax.devices()[0]
    kind = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log(f"# phase 0: device {kind}, jax {jax.__version__}, "
        f"compile cache {cache}")
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"  card: {card}")
    t0 = time.perf_counter()
    if opts.cards:
        phase_cards(opts, opts.cards)
    else:
        smoke(opts, card)
    log(f"# all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": kind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
