"""Backend dispatch: route each bucket to an XLA engine.

Per-bucket static decision (made at trace time from host-side layout
metadata, so it is part of the jit cache key via the operator's aux data):
chunk-granular engine for contiguous-range buckets (ops/xla_spmv.py), the
minimal-op chain for several real chunked buckets of one chunk size,
element granularity otherwise, and colored gather rounds under the colored
schedule (ops/colored.py).

Backend strings carried by operators (``BACKENDS``): "auto" and "xla", both
the XLA engines.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from .xla_spmv import bucket_apply, chunked_bucket_apply, chunked_multi_apply

__all__ = ["apply_operand", "apply_symmetric", "check_backend", "BACKENDS"]

BACKENDS = ("auto", "xla")


def check_backend(backend: str) -> str:
    """Validate an operator's ``backend=`` string."""
    if backend not in BACKENDS:
        raise ValueError(
            f"backend={backend!r} is not one of {', '.join(BACKENDS)}")
    return backend


def _xla_engine(dev_buckets, layout, out_len, x, *, transpose, conj,
                precision, scatter, symmetric=False, colors=None):
    """The XLA engines: chunk-granular engine for chunked buckets, element
    engine (optionally sorted-scatter) for the rest.

    ``symmetric=True`` emits each bucket's forward AND transposed
    contribution from one read of its values (the one-read fused pass).

    ``colors``: the operator's color sets (schedule="colored" only).  When
    profitable, the element buckets run the colored gather-round plan
    (ops/colored.py) instead of scatter-add -- the plan whose correctness
    *depends* on the coloring invariant (the serial/colored duality test is
    the reference's 1-vs-5-thread CI analog and can now actually fail)."""
    host_buckets = layout.buckets
    y = None
    # minimal-op composition over the chunked buckets: one shared gather,
    # per-bucket einsums, ONE one-hot scatter dot in place of a dependent
    # chain of ~3 ops per bucket
    multi_pos: list[int] = []
    if not symmetric and os.environ.get("BST_MULTI", "auto") != "never":
        by_chunk: dict[int, list[int]] = {}
        for pos, hb in enumerate(host_buckets):
            if hb.chunk > 1:
                by_chunk.setdefault(hb.chunk, []).append(pos)
        if by_chunk:
            cand = max(by_chunk.values(), key=len)
            # complex check over the CANDIDATE buckets only -- an unrelated
            # complex elem-granularity bucket must not disable the
            # minimal-op chain for the real chunked group
            dt = jnp.result_type(
                x.dtype, *[dev_buckets[p][0].dtype for p in cand]
            )
            C_ = host_buckets[cand[0]].chunk
            n_rows = sum(
                host_buckets[p].nblocks
                * ((host_buckets[p].kp if transpose
                    else host_buckets[p].mp) // C_)
                for p in cand)
            W_ = -(-out_len // C_)
            if (len(cand) >= 2
                    and not jnp.issubdtype(dt, jnp.complexfloating)
                    and W_ * n_rows * 2 <= 4 << 20):
                multi_pos = cand
    if multi_pos:
        part = chunked_multi_apply(
            [host_buckets[p] for p in multi_pos],
            [dev_buckets[p][0] for p in multi_pos],
            out_len, x, transpose=transpose, conj=conj,
            precision=precision,
        )
        y = part if y is None else y + part
    elem_dev, elem_host, elem_ids = [], [], []
    for pos, (hb, (vals, ridx, cidx)) in enumerate(
            zip(host_buckets, dev_buckets)):
        if pos in multi_pos:
            continue
        if hb.chunk > 1:
            rc = jnp.asarray(hb.row_chunk_idx)
            cc = jnp.asarray(hb.col_chunk_idx)
            part = chunked_bucket_apply(
                vals, rc, cc, hb.chunk, out_len, x,
                transpose=transpose, conj=conj, precision=precision,
                row_chunk_max=int(hb.row_chunk_idx.max()),
                col_chunk_max=int(hb.col_chunk_idx.max()),
                symmetric=symmetric,
            )
            y = part if y is None else y + part
        else:
            elem_dev.append((vals, ridx, cidx))
            elem_host.append(hb)
            elem_ids.append(pos)
    if elem_dev:
        cplan = None
        if colors is not None and scatter != "sorted":
            from .colored import build_colored_plan, colored_mode, colored_wins

            mode = colored_mode()
            n_entries = sum(
                hb.nblocks * (hb.mp + hb.kp if symmetric
                              else (hb.kp if transpose else hb.mp))
                for hb in elem_host
            )
            if mode == "always" or (
                mode == "auto"
                and colored_wins(len(colors), out_len, n_entries)
            ):
                cplan = build_colored_plan(
                    layout, colors, out_len, transpose, elem_ids,
                    symmetric=symmetric,
                )
        sinfo = (
            _sorted_scatter_info(elem_host, transpose)
            if scatter == "sorted" and not symmetric and cplan is None
            else None
        )
        part = bucket_apply(
            elem_dev, out_len, x, transpose=transpose, conj=conj,
            precision=precision, scatter_info=sinfo, symmetric=symmetric,
            colored_plan=cplan,
        )
        y = part if y is None else y + part
    return y


def _sorted_scatter_info(host_buckets, transpose: bool):
    """Host-side scatter permutations for the sort+segment-sum strategy."""
    info = []
    for hb in host_buckets:
        targets = (hb.col_idx if transpose else hb.row_idx).reshape(-1)
        perm = np.argsort(targets, kind="stable")
        info.append(
            (jnp.asarray(perm.astype(np.int32)),
             jnp.asarray(targets[perm].astype(np.int32)))
        )
    return info


def _zeros_out(out_len, x, dtype):
    shape = (out_len,) if x.ndim == 1 else (out_len, x.shape[1])
    return jnp.zeros(shape, dtype=dtype)


def apply_operand(
    dev_buckets,
    layout,
    out_len: int,
    x,
    *,
    transpose: bool = False,
    conj: bool = False,
    precision=None,
    scatter: str = "atomic",
    colors=None,
):
    """Apply a bucketed operand with per-bucket engine routing.

    ``colors``: color sets (tuple of tuples of block ids) when the
    operator's schedule is "colored" -- enables the colored gather-round
    plan on the element engine (ops/colored.py)."""
    y = _xla_engine(
        dev_buckets, layout, out_len, x, transpose=transpose, conj=conj,
        precision=precision, scatter=scatter, colors=colors,
    )
    if y is None:
        dtype = jnp.result_type(x.dtype, *[v.dtype for v, _, _ in dev_buckets])
        return _zeros_out(out_len, x, dtype)
    return y


def apply_symmetric(
    diag_buckets,
    diag_layout,
    off_buckets,
    off_layout,
    n: int,
    x,
    *,
    transpose: bool = False,
    conj: bool = False,
    precision=None,
    diag_colors=None,
    fused_colors=None,
):
    """Symmetric operand: S = D + O + O^T.

    The off-diagonal pair is transpose-invariant and runs as a one-read
    pass: each stored block is read once and feeds both contributions (the
    reference reads each block twice, symmetricblockmatrix.jl:394-418).
    The diagonal pass honors both flags.
    """
    # ``fused_colors`` (union-conflict sets, fusedcolors()) let the element
    # buckets run the colored gather rounds for BOTH scatters
    # (ops/colored.py).
    y = _xla_engine(
        off_buckets, off_layout, n, x, transpose=False, conj=conj,
        precision=precision, scatter="atomic", symmetric=True,
        colors=fused_colors,
    )
    diag = apply_operand(
        diag_buckets, diag_layout, n, x, transpose=transpose,
        conj=conj, precision=precision, colors=diag_colors,
    )
    return diag if y is None else y + diag
