"""Engine-oracle battery: every XLA engine against scipy at 1e-13.

These are the engines every product runs on the GPU.  Each case builds an
operator whose layout routes through one engine, checks (with a spy on the
dispatch layer) that this engine really ran, and compares the forward,
transposed and adjoint products with the scipy oracle in float64 /
complex128.
"""

import numpy as np
import pytest

import blocksparse as bst
from blocksparse.ops import colored, dispatch

TOL = 1e-13


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _vals(rng, shape, dtype):
    v = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(dtype)


def _aligned(rng, dtype, n, bs, per_row):
    """bs x bs blocks at bs-aligned positions, ``per_row`` in each of the
    first block rows (distinct block columns)."""
    nt = n // bs
    blocks, rows, cols = [], [], []
    for bi, k in enumerate(per_row):
        for bj in rng.choice(nt, size=k, replace=False):
            blocks.append(_vals(rng, (bs, bs), dtype))
            rows.append(np.arange(bi * bs, (bi + 1) * bs))
            cols.append(np.arange(bj * bs, (bj + 1) * bs))
    return blocks, rows, cols


def _scattered(rng, dtype, n, nb, width):
    """Blocks on sorted, non-contiguous index lists spread over [0, n)."""
    blocks, rows, cols = [], [], []
    for _ in range(nb):
        m, k = rng.integers(3, width, size=2)
        blocks.append(_vals(rng, (m, k), dtype))
        rows.append(np.sort(rng.choice(n, size=m, replace=False)))
        cols.append(np.sort(rng.choice(n, size=k, replace=False)))
    return blocks, rows, cols


def build(engine, dtype, rng):
    """(operator, name of the dispatch function that must run, check)."""
    n = 192
    if engine == "chunked":       # one chunked bucket, one block per row
        b, r, c = _aligned(rng, dtype, n, 16, [1] * 12)
        return bst.VariableBlockCompressedRowStorage(b, r, c, (n, n))
    if engine == "multi":         # k-merge makes two chunk-16 buckets
        b, r, c = _aligned(rng, dtype, n, 16, [1, 2, 1, 2, 2, 1, 1, 2])
        return bst.BlockSparseMatrix(b, r, c, (n, n))
    b, r, c = _scattered(rng, dtype, n, 14, 24)
    if engine == "element":
        return bst.BlockSparseMatrix(b, r, c, (n, n))
    if engine == "sorted":
        return bst.BlockSparseMatrix(b, r, c, (n, n), scatter="sorted")
    if engine == "colored":
        return bst.BlockSparseMatrix(b, r, c, (n, n), schedule="colored")
    assert engine == "symmetric"
    d = [_vals(rng, (len(x), len(x)), dtype) for x in r[:4]]
    return bst.SymmetricBlockMatrix(d, r[:4], b[4:], r[4:], c[4:], (n, n))


def _spy(monkeypatch, calls):
    for name in ("bucket_apply", "chunked_bucket_apply",
                 "chunked_multi_apply"):
        real = getattr(dispatch, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw))
            return _real(*a, **kw)

        monkeypatch.setattr(dispatch, name, wrapped)
    real_plan = colored.build_colored_plan

    def plan(*a, **kw):
        out = real_plan(*a, **kw)
        calls.append(("colored_plan", {"built": out is not None}))
        return out

    monkeypatch.setattr(colored, "build_colored_plan", plan)


def _ran(engine, calls, complex_):
    names = [c[0] for c in calls]
    if engine == "chunked":
        return "chunked_bucket_apply" in names
    if engine == "multi":
        # the one-hot chain is real-only: complex buckets loop per bucket
        if complex_:
            return names.count("chunked_bucket_apply") >= 2
        return "chunked_multi_apply" in names
    elem = [kw for nm, kw in calls if nm == "bucket_apply"]
    if engine == "element":
        return any(kw["scatter_info"] is None and kw["colored_plan"] is None
                   for kw in elem)
    if engine == "sorted":
        return any(kw["scatter_info"] is not None for kw in elem)
    if engine == "colored":
        return any(kw["colored_plan"] is not None for kw in elem)
    return any(kw.get("symmetric") for nm, kw in calls
               if nm in ("bucket_apply", "chunked_bucket_apply"))


ENGINES = ["chunked", "multi", "element", "sorted", "colored", "symmetric"]


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("mode", ["fwd", "T", "H"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_oracle(engine, dtype, mode, r, monkeypatch):
    monkeypatch.setenv("BST_COLORED", "always" if engine == "colored"
                       else "never")
    rng = np.random.default_rng(ENGINES.index(engine))
    A = build(engine, dtype, rng)
    S = bst.to_scipy(A)
    transpose, conj = {"fwd": (False, False), "T": (True, False),
                       "H": (True, True)}[mode]
    ref_op = {"fwd": S, "T": S.T, "H": S.conj().T}[mode]
    n_in = A.shape[0] if transpose else A.shape[1]
    x = _vals(rng, (n_in,) if r == 1 else (n_in, r), dtype)
    calls = []
    _spy(monkeypatch, calls)
    # un-jitted, so the dispatch layer runs (and is spied on) every time
    y = A._apply(np.asarray(x), transpose, conj)
    assert _ran(engine, calls, np.iscomplexobj(x)), calls
    assert relerr(y, ref_op @ x) < TOL
