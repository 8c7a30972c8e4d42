"""Reference-semantics XLA compute path: gather -> batched einsum -> scatter-add.

This is the general path that works for *arbitrary, non-contiguous* index
lists (the reference's format-1 semantics, blockmatrix.jl:225-247, where the
hot loop is a BLAS gemv on ``view``s).  Here the views become explicit
data movement:

  1. gather   ``xg = x_ext[col_idx]``            (small: x rows only)
  2. compute  ``yp = einsum('bmk,bkr->bmr')``    (the bandwidth-bound hot op)
  3. scatter  ``acc.at[row_idx].add(yp)``        (XLA scatter-add)

Sentinel convention (see core/layout.py): padded gather lanes read the zero
row ``x_ext[N]``; padded scatter rows land in the dropped slot ``acc[M]``.
Scatter-add replaces the reference's graph-coloring race avoidance: no
colors are needed for correctness on this path (coloring remains a
first-class component for the colored gather rounds, ops/colored.py, and the
parallel execution plans; see blocksparse/coloring/).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["bucket_apply", "chunked_bucket_apply", "extend_input", "BucketArrays"]


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _block_contract(spec, v, xg, r, transpose, acc_dtype, precision):
    """Per-block contraction.

    r == 1 (SpMV): with ``precision`` set (the format default is
    "highest") a matrix-vector einsum carrying that precision; with
    ``precision=None`` an elementwise multiply + reduce, which is exact in
    the accumulation dtype whatever the backend's default matmul precision
    (a default-precision float32 dot may run in TF32 or bf16 passes).  The
    choice is not measured on the H200."""
    if r == 1 and precision is None:
        x1 = xg[..., 0].astype(acc_dtype)
        vv = v.astype(acc_dtype) if v.dtype != acc_dtype else v
        if transpose:
            return jnp.sum(vv * x1[:, :, None], axis=1)[..., None]
        return jnp.sum(vv * x1[:, None, :], axis=-1)[..., None]
    if r == 1:
        x1 = xg[..., 0]
        if transpose:
            # x-first orientation: contraction runs over v's sublane dim in
            # the standard GEMM layout ([1,m] @ [m,k]) -- no transposition
            # of the streamed block values
            y = jnp.einsum(
                "bm,bmk->bk", x1, v, preferred_element_type=acc_dtype,
                precision=precision,
            )
        else:
            y = jnp.einsum(
                "bmk,bk->bm", v, x1, preferred_element_type=acc_dtype,
                precision=precision,
            )
        return y[..., None]
    return jnp.einsum(
        spec, v, xg, preferred_element_type=acc_dtype, precision=precision
    )

# A "device bucket" is a triple (values[nb,mp,kp], row_idx[nb,mp], col_idx[nb,kp]).
BucketArrays = tuple


def extend_input(x: jnp.ndarray) -> jnp.ndarray:
    """Append one zero row so sentinel gathers read 0."""
    pad = jnp.zeros((1,) + x.shape[1:], dtype=x.dtype)
    return jnp.concatenate([x, pad], axis=0)


def bucket_apply(
    buckets,
    out_len: int,
    x: jnp.ndarray,
    *,
    transpose: bool = False,
    conj: bool = False,
    acc_dtype=None,
    precision=None,
    scatter_info=None,
    symmetric: bool = False,
    colored_plan=None,
):
    """Apply a bucketed block-sparse operand to ``x`` ([n] or [n, r]).

    ``buckets``: iterable of (values, row_idx, col_idx) device triples.
    ``out_len``: number of output rows (M for forward, N for transpose).
    In transpose mode the roles of the two index tables swap and each block's
    values are used transposed -- a pure flag flip, no data movement
    (parity with the reference's lazy Adjoint/Transpose wrapping,
    blockmatrix.jl:154-206).

    ``scatter_info``: optional parallel list; entry i is None (use the
    deterministic scatter-add) or a (perm, sorted_targets) pair for the
    sort + sorted-segment-sum strategy (SURVEY.md §7 stance 3): the
    contributions are permuted into target order and reduced with
    ``segment_sum(indices_are_sorted=True)``, which lowers to a fast
    sequential reduction instead of a random-index scatter.

    ``symmetric``: emit BOTH the forward and the transposed contribution of
    every block from ONE read of its values (the fused one-read pass --
    the reference reads each off-diagonal block twice,
    symmetricblockmatrix.jl:394-418; XLA multi-output fusion keeps the two
    contractions in a single traversal of ``vals``).  Requires out_len ==
    n_in; ``transpose`` is ignored (the pair is transpose-invariant).

    ``colored_plan``: optional (tables, total) from ops/colored.py -- the
    colored execution plan.  All scatter-adds are replaced by one dense
    gather per color over the flattened contributions (requires
    ``symmetric=False``; see ops/colored.py for why the coloring invariant
    makes this inverse map well-defined).
    """
    vec = x.ndim == 1
    xm = x[:, None] if vec else x
    r = xm.shape[1]
    x_ext = extend_input(xm)

    if acc_dtype is None:
        vdts = [v.dtype for v, _, _ in buckets]
        acc_dtype = jnp.result_type(xm.dtype, *vdts) if vdts else xm.dtype
    acc = jnp.zeros((out_len + 1, r), dtype=acc_dtype)
    if scatter_info is None:
        scatter_info = [None] * len(buckets)

    def gather(src_ext, idx):
        # src_ext is x with the appended zero row (sentinel lanes read 0)
        return src_ext[idx]

    flat_parts = [] if colored_plan is not None else None
    flat_mirror = [] if colored_plan is not None and symmetric else None
    for (vals, ridx, cidx), sinfo in zip(buckets, scatter_info):
        v = jnp.conj(vals) if conj else vals
        if transpose and not symmetric:
            gather_idx, scatter_idx = ridx, cidx
            spec = "bmk,bmr->bkr"
        else:
            gather_idx, scatter_idx = cidx, ridx
            spec = "bmk,bkr->bmr"
        xg = gather(x_ext, gather_idx)  # [nb, g, r]
        yp = _block_contract(spec, v, xg, r, transpose and not symmetric,
                             acc_dtype, precision)
        ypf = yp.reshape(-1, r)
        if flat_parts is not None:
            flat_parts.append(ypf)
        elif sinfo is None:
            acc = acc.at[scatter_idx.reshape(-1)].add(
                ypf, indices_are_sorted=False, unique_indices=False
            )
        else:
            perm, targets = sinfo
            acc = acc + jax.ops.segment_sum(
                ypf[perm], targets, num_segments=out_len + 1,
                indices_are_sorted=True,
            )
        if symmetric:
            # transposed contribution from the same v read (one-read fusion)
            xr = gather(x_ext, ridx)  # [nb, m, r]
            yt = _block_contract("bmk,bmr->bkr", v, xr, r, True,
                                 acc_dtype, precision)
            ytf = yt.reshape(-1, r)
            if flat_mirror is not None:
                flat_mirror.append(ytf)
            else:
                acc = acc.at[cidx.reshape(-1)].add(
                    ytf, indices_are_sorted=False, unique_indices=False,
                )

    if flat_parts is not None:
        # colored rounds: y = sum_c contrib[src_table_c] (scatter-free);
        # symmetric plans lay out all forward parts then all mirror parts
        # (the order _plan_cached's offsets assume)
        tables, total = colored_plan
        all_parts = flat_parts + (flat_mirror or [])
        contrib = (
            jnp.concatenate(all_parts, axis=0)
            if all_parts
            else jnp.zeros((0, r), dtype=acc_dtype)
        )
        contrib_ext = jnp.concatenate(
            [contrib, jnp.zeros((1, r), dtype=acc_dtype)], axis=0
        )
        out = jnp.zeros((out_len, r), dtype=acc_dtype)
        for t in tables:
            out = out + contrib_ext[t]
        return out[:, 0] if vec else out

    out = acc[:out_len]
    return out[:, 0] if vec else out


def chunked_bucket_apply(
    vals,
    row_chunk_idx,
    col_chunk_idx,
    chunk: int,
    out_len: int,
    x: jnp.ndarray,
    *,
    transpose: bool = False,
    conj: bool = False,
    acc_dtype=None,
    precision=None,
    row_chunk_max: int | None = None,
    col_chunk_max: int | None = None,
    symmetric: bool = False,
):
    """Chunk-granular engine for contiguous-range buckets.

    Blocks are stored offset-shifted so their tiles cover whole C-aligned
    chunks of x and y (core/layout.py Bucket docstring); the gather and
    scatter-add then move [C(, r)]-shaped rows of ``x.reshape(-1, C)`` /
    ``y.reshape(-1, C)`` instead of single elements -- C times fewer
    indices, and row-shaped instead of scalar access.  The offset-padding
    zeros in ``vals`` make the extra covered elements contribute exactly 0.
    """
    C = int(chunk)
    vec = x.ndim == 1
    xm = x[:, None] if vec else x
    n_in, r = xm.shape
    nb, mp, kp = vals.shape
    if acc_dtype is None:
        acc_dtype = jnp.result_type(xm.dtype, vals.dtype)

    if transpose and not symmetric:
        gather_idx, scatter_idx = row_chunk_idx, col_chunk_idx
        g_extent, s_extent = mp, kp
        spec = "bmk,bmr->bkr"
        tr = True
    else:
        gather_idx, scatter_idx = col_chunk_idx, row_chunk_idx
        g_extent, s_extent = kp, mp
        spec = "bmk,bkr->bmr"
        tr = False

    v = jnp.conj(vals) if conj else vals
    g_max = row_chunk_max if tr else col_chunk_max
    s_max = col_chunk_max if tr else row_chunk_max
    if symmetric:
        # both index sets gather AND scatter: use the conservative bound
        g_max = s_max = (
            None
            if row_chunk_max is None or col_chunk_max is None
            else max(row_chunk_max, col_chunk_max)
        )

    # pad elision: when the host layout guarantees every gathered window is
    # in range and out_len is chunk-aligned, skip the pad and the final
    # slice -- the graph shrinks to gather / contract / scatter, which is
    # what keeps tiny matvecs (a handful of us) near the roofline.
    g_pad_extent = max(g_extent, s_extent) if symmetric else g_extent
    if g_max is not None and n_in % C == 0 and (g_max + 1) * C <= n_in:
        x2 = xm.reshape(n_in // C, C, r)
    else:
        in_rows = _round_up(n_in, C) + g_pad_extent
        x2 = jnp.pad(xm, ((0, in_rows - n_in), (0, 0))).reshape(
            in_rows // C, C, r
        )
    xg = x2[gather_idx].reshape(nb, g_extent, r)
    yp = _block_contract(spec, v, xg, r, tr, acc_dtype, precision)
    upd = yp.reshape(nb, s_extent // C, C, r)
    s_pad_extent = max(g_extent, s_extent) if symmetric else s_extent
    elide = s_max is not None and out_len % C == 0 and (s_max + 1) * C <= out_len
    if elide:
        y2 = jnp.zeros((out_len // C, C, r), dtype=acc_dtype)
    else:
        out_rows = _round_up(out_len, C) + s_pad_extent
        y2 = jnp.zeros((out_rows // C, C, r), dtype=acc_dtype)
    y2 = y2.at[scatter_idx].add(upd)
    if symmetric:
        # transposed contribution from the same v read (one-read fusion;
        # the reference reads each stored off-diagonal twice,
        # symmetricblockmatrix.jl:394-418)
        xr = x2[row_chunk_idx].reshape(nb, mp, r)
        yt = _block_contract("bmk,bmr->bkr", v, xr, r, True,
                             acc_dtype, precision)
        y2 = y2.at[col_chunk_idx].add(yt.reshape(nb, kp // C, C, r))
    if elide:
        out = y2.reshape(out_len, r)
    else:
        out = y2.reshape(-1, r)[:out_len]
    return out[:, 0] if vec else out


from collections import OrderedDict

# Host-side tables for chunked_multi_apply, cached per (bucket set,
# transpose, out_len).  The scatter one-hot alone is up to W x n_rows f32
# (~MBs) of host numpy per build; under jit it is trace-time only, but
# eager paths (scipy-LinearOperator adapter, un-jitted A @ x) would
# otherwise pay milliseconds per matvec.  Bounded LRU keyed by bucket
# identity; each entry holds strong refs to its bucket tuple so the ids in
# its key cannot be reused while the entry is alive.  Only HOST arrays are
# cached: a device array made inside a jit trace is a trace-local tracer,
# and caching one would leak it into later traces.
_MULTI_HOST_CACHE: "OrderedDict" = OrderedDict()
_MULTI_HOST_CACHE_MAX = 32


def _multi_host_tables(host_buckets, out_len: int, transpose: bool):
    """gidx/goff/sOH/g_max for the minimal-op chain (host tables cached)."""
    import numpy as np

    key = (
        tuple(id(hb) for hb in host_buckets), bool(transpose), int(out_len)
    )
    hit = _MULTI_HOST_CACHE.get(key)
    if hit is None:
        C = int(host_buckets[0].chunk)
        tab = "row_chunk_idx" if transpose else "col_chunk_idx"
        stab = "col_chunk_idx" if transpose else "row_chunk_idx"
        g_flat = [np.asarray(getattr(hb, tab)).reshape(-1)
                  for hb in host_buckets]
        s_flat = np.concatenate(
            [np.asarray(getattr(hb, stab)).reshape(-1) for hb in host_buckets]
        )
        goff = np.cumsum([0] + [g.size for g in g_flat])
        g_cat = np.concatenate(g_flat)
        W = _round_up(out_len, C) // C
        sOH = np.zeros((W, s_flat.size), np.float32)
        keep = s_flat < W          # sentinel rows (if any) drop
        sOH[s_flat[keep], np.nonzero(keep)[0]] = 1.0
        hit = (tuple(host_buckets),
               (g_cat.astype(np.int32), goff, sOH, int(g_cat.max())))
        _MULTI_HOST_CACHE[key] = hit
        while len(_MULTI_HOST_CACHE) > _MULTI_HOST_CACHE_MAX:
            _MULTI_HOST_CACHE.popitem(last=False)
    else:
        _MULTI_HOST_CACHE.move_to_end(key)
    gidx, goff, sOH, g_max = hit[1]
    return jnp.asarray(gidx), goff, jnp.asarray(sOH, jnp.bfloat16), g_max


def chunked_multi_apply(
    host_buckets,
    dev_vals,
    out_len: int,
    x,
    *,
    transpose: bool = False,
    conj: bool = False,
    acc_dtype=None,
    precision=None,
):
    """Minimal-op chain over SEVERAL chunked buckets: ONE shared gather,
    one einsum per bucket, ONE one-hot scatter dot.

    The per-bucket loop costs ~3 serialized ops per bucket; this
    composition needs one gather and one dot for all of them (its gain is
    not measured on the H200).  The one-hot scatter is exact: 0/1 one-hots
    against float values at HIGHEST reproduce the addends bit-for-bit, and
    replace the per-bucket scatter-adds with a single matmul.

    Requirements (checked by the caller): every bucket chunked with the
    SAME chunk, real (non-complex) values, not symmetric.  (The math is
    contiguity-independent -- chunk tables are self-contained -- so
    nothing here relies on contiguous index lists.)  Reference semantics
    parity: blockmatrix.jl:225-247 (same gather/contract/scatter math,
    reordered summation).
    """
    C = int(host_buckets[0].chunk)
    vec = x.ndim == 1
    xm = x[:, None] if vec else x
    n_in, r = xm.shape
    if acc_dtype is None:
        acc_dtype = jnp.result_type(xm.dtype, *[v.dtype for v in dev_vals])

    spec_tr = bool(transpose)
    gidx, goff, sOH, g_max = _multi_host_tables(
        tuple(host_buckets), out_len, spec_tr
    )
    W = _round_up(out_len, C) // C

    rows_in = max(_round_up(n_in, C), (g_max + 1) * C)
    x2 = (jnp.pad(xm, ((0, rows_in - n_in), (0, 0)))
          if rows_in > n_in else xm).reshape(rows_in // C, C, r)
    xg_all = x2[gidx]                                   # [Gtot, C, r]

    rows = []
    for bi, (hb, v) in enumerate(zip(host_buckets, dev_vals)):
        nb, mp, kp = v.shape
        g_extent = mp if spec_tr else kp
        s_extent = kp if spec_tr else mp
        vv = jnp.conj(v) if conj else v
        xg = xg_all[goff[bi]:goff[bi + 1]].reshape(nb, g_extent, r)
        spec = "bmk,bmr->bkr" if spec_tr else "bmk,bkr->bmr"
        yp = _block_contract(spec, vv, xg, r, spec_tr, acc_dtype, precision)
        rows.append(yp.reshape(nb * (s_extent // C), C * r))
    allrows = rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=0)
    u = jnp.dot(sOH, allrows, preferred_element_type=acc_dtype,
                precision=jax.lax.Precision.HIGHEST)
    out = u.reshape(W * C, r)[:out_len]
    return out[:, 0] if vec else out
