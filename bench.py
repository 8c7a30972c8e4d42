#!/usr/bin/env python
"""Benchmark: block-sparse SpMV/SpMM time and roofline share on a GPU.

    python bench.py        # one JSON line on stdout, details on stderr

Prints the device line (platform, device kind, count, card name and power
limit) before any number, then for each configuration the median time per
product of

  - the dependent chain: each product's output feeds the next product;
  - the pipelined mode: PIPE independent products on distinct
    same-structure operands in one program, per product;

with the share of the card's HBM roofline (bytes the product must move over
the peak bandwidth of ``PEAKS``).  Headline (BASELINE.json config 1):
general SpMV, 4096x4096, 200 uniform 64x64 float32 blocks.  These configs
are a few MB and so live in the card's 50 MB L2: they measure launch and
latency, not HBM streaming.

A device that is not in ``PEAKS`` is an error: there is no default peak.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks, dense rates without sparsity (NVIDIA H200 SXM data sheet;
# they assume the card's full 700 W power limit).
PEAKS = {
    "NVIDIA H200": {
        "hbm_bytes_per_s": 4.8e12,
        "f32_flops_per_s": 67e12,      # outside the tensor cores
        "tf32_flops_per_s": 495e12,
        "bf16_flops_per_s": 989e12,
    },
}

PIPE = 4  # independent products in flight for the pipelined mode


def peaks(device_kind: str) -> dict:
    """The peak rates of ``device_kind``; an unknown device raises."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"bench.PEAKS (known: {', '.join(sorted(PEAKS))})")
    return PEAKS[device_kind]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_config1(n=4096, nblocks=200, bs=64, seed=7, dtype=np.float32,
                  value_seed=None, **kw):
    """~200 uniform bs x bs blocks at block-aligned positions (config 1).

    ``value_seed`` re-rolls the block VALUES only (identical sparsity
    structure): the pipelined mode runs PIPE same-structure operands with
    distinct values so XLA cannot merge their value reads."""
    import blocksparse as bst

    rng = np.random.default_rng(seed)
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    rows = (pos // ntiles) * bs
    cols = (pos % ntiles) * bs
    vrng = np.random.default_rng(seed + 7777 if value_seed is None
                                 else value_seed)
    blocks = [vrng.standard_normal((bs, bs)).astype(dtype)
              for _ in range(nblocks)]
    return bst.BlockSparseMatrix(
        blocks,
        [np.arange(r, r + bs) for r in rows],
        [np.arange(c, c + bs) for c in cols],
        (n, n),
        **kw,
    )


def build_config2(n=4096, seed=8, value_seed=None, **kw):
    """Symmetric with half-stored off-diagonals (config 2)."""
    import blocksparse as bst
    from blocksparse.utils.testmatrices import random_symmetric

    d, di, o, ri, ci, shape = random_symmetric(
        seed, n=n, ngroups=48, noffdiag=160, dtype=np.float32, contiguous=True
    )
    if value_seed is not None:
        vr = np.random.default_rng(value_seed)
        d = [((lambda b: (b + b.T) / 2)(vr.standard_normal(blk.shape))
              ).astype(blk.dtype) for blk in d]
        o = [vr.standard_normal(b.shape).astype(b.dtype) for b in o]
    return bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape, **kw)


def build_config3(n=4096, seed=9, value_seed=None, **kw):
    """VBCRS with mixed 16-128 blocks (config 3)."""
    import blocksparse as bst

    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 7777 if value_seed is None
                                 else value_seed)
    bounds = [0]
    while bounds[-1] < n:
        bounds.append(min(n, bounds[-1] + int(rng.integers(16, 129))))
    groups = [np.arange(bounds[i], bounds[i + 1])
              for i in range(len(bounds) - 1)]
    ng = len(groups)
    blocks, rs, cs = [], [], []
    for gi in range(ng):
        for gj in rng.choice(ng, size=min(6, ng), replace=False):
            blocks.append(vrng.standard_normal(
                (len(groups[gi]), len(groups[int(gj)]))).astype(np.float32))
            rs.append(int(groups[gi][0]))
            cs.append(int(groups[int(gj)][0]))
    return bst.VariableBlockCompressedRowStorage(
        blocks, rs, cs, (n, n), granularity=(8, 128), **kw
    )


def build_config_s(n=16384, nblocks=400, bs=128, seed=12, value_seed=None,
                   **kw):
    """Scattered lists: sorted, locally clustered gather lists like the
    reference's BEM fixtures (SURVEY.md §4), 26 MB of values."""
    import blocksparse as bst

    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 7777 if value_seed is None
                                 else value_seed)
    span = int(bs * 1.3)
    blocks, rows, cols = [], [], []
    for _ in range(nblocks):
        blocks.append(vrng.standard_normal((bs, bs)).astype(np.float32))
        rb = int(rng.integers(0, n - span))
        cb = int(rng.integers(0, n - span))
        rows.append(rb + np.sort(rng.choice(span, bs, replace=False)))
        cols.append(cb + np.sort(rng.choice(span, bs, replace=False)))
    return bst.BlockSparseMatrix(blocks, rows, cols, (n, n), **kw)


def bench_modes(As, x, chain=32):
    """(dep, piped): seconds per product, each a ``time_fn`` dict.

    ``As``: PIPE operands with identical structure but distinct values."""
    import jax
    import jax.numpy as jnp

    from blocksparse.utils.timing import time_fn

    @jax.jit
    def dep(A, v):
        return jax.lax.fori_loop(0, chain, lambda i, u: (A @ u) * 1e-3, v)

    @jax.jit
    def piped(As, X):
        return jnp.stack([As[i] @ X[:, i] for i in range(PIPE)], axis=1)

    X = jnp.stack([x * (i + 1) for i in range(PIPE)], axis=1)
    td = time_fn(dep, As[0], x)
    tp = time_fn(piped, tuple(As), X)
    per = lambda t, k: {key: (v / k if key != "n" else v)
                        for key, v in t.items()}
    return per(td, chain), per(tp, PIPE)


def fmt(t):
    return (f"median {t['median'] * 1e6:.2f} us (p10 {t['p10'] * 1e6:.2f}, "
            f"p90 {t['p90'] * 1e6:.2f}, n={t['n']})")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from blocksparse.utils.compile_cache import use_checkout_cache

    use_checkout_cache(ROOT)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    pk = peaks(dev.device_kind)
    card = card_line()
    log(f"# device {device}, card {card}")
    bw = pk["hbm_bytes_per_s"]
    rng = np.random.default_rng(0)
    out = {"device": device, "card": card}

    def run(name, build, value_seeds, logical_bytes):
        t0 = time.perf_counter()
        As = [build()] + [build(value_seed=s) for s in value_seeds]
        x = jnp.asarray(rng.standard_normal(As[0].shape[1])
                        .astype(np.float32))
        dep, pip = bench_modes(As, x)
        roof = logical_bytes(As[0]) / bw
        log(f"# {name}: set-up {time.perf_counter() - t0:.1f} s | piped "
            f"{fmt(pip)} = {100 * roof / pip['median']:.1f}% of HBM "
            f"roofline | dep chain {fmt(dep)} = "
            f"{100 * roof / dep['median']:.1f}%")
        return As, dep, pip, roof

    def nnz_bytes(A):
        return A.nnz * 4 + 2 * A.shape[0] * 4

    As, dep, pip, roof = run("config1 spmv 4096/200x64x64", build_config1,
                             range(101, 100 + PIPE), nnz_bytes)
    out.update({
        "metric": "block_spmv_4096_200x64x64_f32_roofline_fraction",
        "value": roof / pip["median"],
        "unit": "fraction_of_hbm_roofline",
        "latency_fraction": roof / dep["median"],
        "piped_us": pip["median"] * 1e6,
        "dep_us": dep["median"] * 1e6,
    })

    # config 4: SpMM r=128 on the config-1 matrix, per precision tier
    from blocksparse.utils.timing import time_fn

    r4 = 128
    X = jnp.asarray(rng.standard_normal((As[0].shape[1], r4))
                    .astype(np.float32))
    flops = 2 * As[0].nnz * r4
    for prec in ("highest", "high", None):
        A = build_config1(precision=prec)
        t = time_fn(jax.jit(lambda A, X: A @ X), A, X)
        log(f"# config4 spmm r={r4} precision={prec}: {fmt(t)}, "
            f"{flops / t['median'] / 1e12:.2f} TFLOP/s")
        out[f"spmm_r128_{prec}_us"] = t["median"] * 1e6

    run("config2 symmetric spmv", build_config2, range(201, 200 + PIPE),
        lambda S: (S._dlayout.nnz + S._olayout.nnz) * 4 + 2 * S.shape[0] * 4)
    run("config3 vbcrs mixed 16-128 spmv", build_config3,
        range(301, 300 + PIPE), nnz_bytes)
    run("configS scattered spmv", build_config_s, range(401, 400 + PIPE),
        nnz_bytes)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
