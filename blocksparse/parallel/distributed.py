"""Distributed block-sparse operators over a jax.sharding.Mesh.

The reference is single-process (SURVEY.md §2: no MPI/NCCL anywhere); this
module is the scaling layer it lacks: 1-D **block-row
partitioning** over a device mesh with XLA collectives (BASELINE.json
north star).

Execution model per shard (inside ``shard_map``):

  1. **Halo exchange**: neighbor ``ppermute`` rounds move only the
     128-element x chunks this shard's boundary-crossing blocks actually
     read (plan computed at construction, ``partition.plan_halo``) -- NOT a
     full ``all_gather``; exchanged bytes scale with the block structure's
     shard overlap, not with N.
  2. **Fully-local blocks** consume the shard's own x slice immediately --
     XLA's latency-hiding scheduler overlaps them with the in-flight
     ``ppermute``s.
  3. Remaining blocks gather from ``[x_local ++ halo]``; contributions to
     rows owned by other shards accumulate into the halo region of
     ``[y_local ++ halo]``.
  4. **Reverse halo exchange**: the y-halo region rides the same plan
     backwards (``ppermute`` with inverted permutation) onto the owning
     shards, which add it in -- the neighbor-granular form of the north
     star's reduce-scatter.

``DistributedBlockOperator`` is a full :class:`LinearOperator` (parity:
the reference keeps complete LinearMaps algebra under its threaded
execution, src/abstractblockmatrix.jl:13,50-62): ``.T``/``.H``/``conj``,
``axpby``, scaling/sum/composition, and solver closures all work.  The
transpose product reuses the SAME stacked values with a transposed
contraction -- the col position table becomes the scatter target and the
row table the gather source -- so no second copy of the matrix exists on
device (mirroring the reference's view-based lazy wrappers,
blockmatrix.jl:154-206).

Symmetric operators are stored **once** (diagonals + half off-diagonals,
parity: symmetricblockmatrix.jl:33-44): the kernel fuses the mirrored
contribution ``y[cols] += B^T x[rows]`` into the same pass that computes
``y[rows] += B x[cols]``, reading each stored block exactly once -- the
distributed analog of the single-device one-read pass (ops/dispatch.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.operator import (
    AdjointOperator,
    ConjOperator,
    LinearOperator,
    TransposeOperator,
)
from ..formats.symmetric import SymmetricBlockMatrix
from .partition import (
    G,
    HaloPlan,
    collect_reads,
    partition_rows,
    plan_halo,
    stack_operand,
)

__all__ = ["DistributedBlockOperator", "distribute"]


@dataclass(frozen=True)
class _Meta:
    """Hashable static descriptor (pytree aux data)."""

    mesh: Mesh
    axis: str
    shape: tuple[int, int]
    dtype: np.dtype
    precision: str
    sym: bool
    rows_per: int
    cols_per: int
    Hr: int  # row-space halo G-chunks per shard
    Hc: int  # col-space halo G-chunks per shard
    row_dists: tuple[int, ...]
    col_dists: tuple[int, ...]
    # per part: "diag" | "off" | "gen"; per bucket: (loc_chunk, rem_chunk),
    # -1 = group absent, 1 = element tables, C>1 = chunk tables.
    part_kinds: tuple[str, ...]
    part_chunks: tuple[tuple[tuple[int, int], ...], ...]
    # optional second mesh axis sharding RHS columns for SpMM (2-D mesh:
    # block-rows x RHS-columns, SURVEY.md §2 parallelism table).  The
    # shard_map body is column-agnostic and its collectives name only the
    # row axis, so each RHS column group runs its own independent halo
    # ring -- no extra collectives.
    rhs_axis: str | None = None

    @property
    def S(self) -> int:
        return self.mesh.shape[self.axis]


def _resolve(op):
    """Unwrap lazy wrappers -> (base, transpose, conj) flags."""
    tr = cj = False
    while isinstance(op, (TransposeOperator, AdjointOperator, ConjOperator)):
        if isinstance(op, TransposeOperator):
            tr = not tr
        elif isinstance(op, AdjointOperator):
            tr = not tr
            cj = not cj
        else:
            cj = not cj
        op = op.op
    return op, tr, cj


@jax.tree_util.register_pytree_node_class
class DistributedBlockOperator(LinearOperator):
    """Block-row-sharded operator bound to a 1-D mesh axis.

    Layouts are reused from the source format (no rebuild); stacked tables
    and halo send schedules are the pytree leaves, so the operator passes
    through ``jit``/``grad`` and one compilation serves all same-structure
    instances.
    """

    def __init__(self, op: LinearOperator, mesh: Mesh, axis: str = "rows",
                 rhs_axis: str | None = None):
        base, tr, cj = _resolve(op)
        if tr or cj:
            raise ValueError(
                "construct from the base operator and wrap lazily: "
                "distribute(A).T instead of distribute(A.T)"
            )
        if rhs_axis is not None and rhs_axis not in mesh.shape:
            raise ValueError(
                f"rhs_axis {rhs_axis!r} not in mesh axes {tuple(mesh.shape)}"
            )
        S = mesh.shape[axis]
        m, n = map(int, base.shape)
        sym = isinstance(base, SymmetricBlockMatrix)
        if sym:
            layouts = [base._dlayout, base._olayout]
            kinds = ["diag", "off"]
        else:
            layouts = [base._layout]
            kinds = ["gen"]
        dtype = np.dtype(base.dtype)
        precision = getattr(base, "_precision", "highest")

        part = partition_rows(m, S)
        rows_per = part.shard_rows
        cols_per = partition_rows(n, S).shard_rows
        if sym:
            assert m == n and rows_per == cols_per
            # one merged plan serves rows and cols (square, same partition):
            # forward gathers x[cols] and x[rows] (mirror), reverse scatters
            # y[rows] and y[cols] (mirror) -- all the same chunk space.
            needed = [set() for _ in range(S)]
            for lay, kind in zip(layouts, kinds):
                for side in ("rows", "cols"):
                    for s, got in enumerate(
                        collect_reads(lay, part, rows_per, cols_per, side)
                    ):
                        needed[s] |= got
            row_halo = col_halo = plan_halo(needed, S, rows_per)
        else:
            lay = layouts[0]
            row_halo = plan_halo(
                collect_reads(lay, part, rows_per, cols_per, "rows"),
                S, rows_per,
            )
            col_halo = plan_halo(
                collect_reads(lay, part, rows_per, cols_per, "cols"),
                S, cols_per,
            )
        self.row_halo = row_halo
        self.col_halo = col_halo

        sharding = jax.sharding.NamedSharding(mesh, P(axis))

        def put(a):
            return jax.device_put(jnp.asarray(a), sharding)

        parts = []
        chunks = []
        for lay in layouts:
            stacked = stack_operand(lay, part, cols_per, row_halo, col_halo)
            bks = []
            cks = []
            for g in stacked:
                row = []
                ck = []
                for key in ("loc", "rem"):
                    grp = g[key]
                    if grp["values"].size:
                        row.append((put(grp["values"]), put(grp["rowtab"]),
                                    put(grp["coltab"])))
                        ck.append(int(grp["chunk"]))
                    else:
                        row.append(None)
                        ck.append(-1)
                bks.append(tuple(row))
                cks.append(tuple(ck))
            parts.append(tuple(bks))
            chunks.append(tuple(cks))

        row_send = tuple(put(t) for t in row_halo.send_idx)
        col_send = (
            row_send if sym else tuple(put(t) for t in col_halo.send_idx)
        )

        self._arrays = (row_send, col_send, tuple(parts))
        self._meta = _Meta(
            mesh=mesh, axis=axis, shape=(m, n), dtype=dtype,
            precision=precision, sym=sym, rows_per=rows_per,
            cols_per=cols_per, Hr=row_halo.halo_chunks,
            Hc=col_halo.halo_chunks, row_dists=row_halo.dists,
            col_dists=col_halo.dists, part_kinds=tuple(kinds),
            part_chunks=tuple(chunks), rhs_axis=rhs_axis,
        )

    # -- pytree --------------------------------------------------------------
    def tree_flatten(self):
        return (self._arrays,), self._meta

    @classmethod
    def tree_unflatten(cls, meta, children):
        obj = object.__new__(cls)
        obj._arrays = children[0]
        obj._meta = meta
        return obj

    # -- LinearOperator surface ----------------------------------------------
    @property
    def shape(self):
        return self._meta.shape

    @property
    def dtype(self):
        return self._meta.dtype

    @property
    def exchanged_bytes_per_call(self) -> int:
        """Static halo traffic per product (r=1, f32), summed over shards --
        the number the weak-scaling harness and tests compare against the
        O(N) full all_gather this plan replaces."""
        b = self.row_halo.exchanged_bytes_per_call
        if not self._meta.sym:
            b += self.col_halo.exchanged_bytes_per_call
        return b

    # -- the shard_map kernel ------------------------------------------------
    def _apply(self, x, transpose, conj):
        if conj:
            # conj(A) @ x == conj(A @ conj(x)): two elementwise passes, no
            # second copy of the operator (parity: lazy ConjOperator).
            return jnp.conj(self._apply(jnp.conj(x), transpose, False))
        mt = self._meta
        m, n = mt.shape
        in_len, out_len = (m, n) if transpose else (n, m)
        vec = x.ndim == 1
        xl = x[:, None] if vec else x
        # input lives in the gather space, output in the scatter space
        in_per = mt.rows_per if transpose else mt.cols_per
        out_per = mt.cols_per if transpose else mt.rows_per
        pad = mt.S * in_per - in_len
        if pad:
            xl = jnp.pad(xl, ((0, pad), (0, 0)))

        axis = mt.axis
        r = xl.shape[1]
        rhs = mt.rhs_axis if (mt.rhs_axis is not None and not vec) else None
        if rhs is not None:
            R = mt.mesh.shape[rhs]
            r_pad = -(-r // R) * R
            if r_pad != r:
                xl = jnp.pad(xl, ((0, 0), (0, r_pad - r)))
            body = self._shard_body(transpose, r_pad // R, xl.dtype)
            x_spec, y_spec = P(axis, rhs), P(axis, rhs)
        else:
            body = self._shard_body(transpose, r, xl.dtype)
            x_spec, y_spec = P(axis, None), P(axis, None)
        fn = jax.shard_map(
            body, mesh=mt.mesh,
            in_specs=(x_spec,) + (P(axis),) * len(self._flat_leaves()),
            out_specs=y_spec,
        )
        y = fn(xl, *self._flat_leaves())[:out_len, :r]
        return y[:, 0] if vec else y

    def _flat_leaves(self):
        row_send, col_send, parts = self._arrays
        flat = list(row_send) + list(col_send)
        for bks in parts:
            for row in bks:
                for grp in row:
                    if grp is not None:
                        flat.extend(grp)
        return tuple(flat)

    def _shard_body(self, transpose, r, xdtype):
        mt = self._meta
        S, axis = mt.S, mt.axis
        sym = mt.sym
        acc_dtype = jnp.result_type(mt.dtype, xdtype)
        # gather space (input) and scatter space (output) per mode
        # (sym: rows_per == cols_per, one merged space)
        in_per = mt.rows_per if (sym or transpose) else mt.cols_per
        out_per = mt.rows_per if (sym or not transpose) else mt.cols_per
        Hin = mt.Hr if (sym or transpose) else mt.Hc
        Hout = mt.Hr if (sym or not transpose) else mt.Hc
        in_dists = mt.row_dists if (sym or transpose) else mt.col_dists
        out_dists = mt.row_dists if (sym or not transpose) else mt.col_dists
        Lin = in_per + Hin * G
        Lout = out_per + Hout * G
        fwd_perm = {d: [(s, (s + d) % S) for s in range(S)] for d in in_dists}
        rev_perm = {d: [(s, (s - d) % S) for s in range(S)] for d in out_dists}

        def body(x_local, *flat):
            it = iter(flat)
            row_send = [next(it) for _ in mt.row_dists]
            col_send = [next(it) for _ in mt.col_dists]
            in_send = row_send if (sym or transpose) else col_send
            out_send = row_send if (sym or not transpose) else col_send
            groups = []  # (kind, key, chunk, vals, rowtab, coltab)
            for kind, cks in zip(mt.part_kinds, mt.part_chunks):
                for ck in cks:
                    for key, c in zip(("loc", "rem"), ck):
                        if c > 0:
                            v, rt, ct = next(it), next(it), next(it)
                            groups.append(
                                (kind, key, c, v[0], rt[0], ct[0])
                            )

            # 1. forward halo exchange over the input space
            halo = []
            if in_dists:
                x3 = x_local.reshape(in_per // G, G, r)
                for d, tab in zip(in_dists, in_send):
                    seg = x3[tab[0]]  # [E, G, r]
                    halo.append(
                        jax.lax.ppermute(seg, axis, fwd_perm[d]).reshape(-1, r)
                    )
            xh = jnp.concatenate(
                [x_local] + halo + [jnp.zeros((1, r), x_local.dtype)]
            )

            acc = jnp.zeros((Lout + 1, r), acc_dtype)

            def contract(vals, xg, swap):
                eq = "bmk,bmr->bkr" if swap else "bmk,bkr->bmr"
                return jnp.einsum(
                    eq, vals, xg, preferred_element_type=acc_dtype,
                    precision=mt.precision,
                )

            def consume(acc, kind, c, vals, rowtab, coltab, src):
                nb = vals.shape[0]
                # which table gathers and which scatters in this mode
                if sym or not transpose:
                    gtab, stab = coltab, rowtab
                else:
                    gtab, stab = rowtab, coltab
                swap = transpose and not sym
                if kind == "diag" and transpose:
                    swap = True  # S^T applies diagonals transposed
                if c == 1:
                    xg = src[gtab]  # [nb, kdim, r] (clamped; zeros pad)
                    y = contract(vals, xg, swap)
                    acc = acc.at[stab.reshape(-1)].add(y.reshape(-1, r))
                    if kind == "off":
                        # fused mirror: one read of vals, second contraction
                        xg2 = src[rowtab]
                        y2 = contract(vals, xg2, True)
                        acc = acc.at[coltab.reshape(-1)].add(
                            y2.reshape(-1, r))
                else:
                    src3 = jnp.concatenate([
                        src[:-1].reshape(-1, c, r),
                        jnp.zeros((1, c, r), src.dtype),
                    ])

                    def chunk_pass(gt, st, swp):
                        xg = src3[gt].reshape(nb, gt.shape[1] * c, r)
                        y = contract(vals, xg, swp)
                        a3 = jnp.zeros((Lout // c + 1, c, r), acc_dtype)
                        a3 = a3.at[st].add(
                            y.reshape(nb, st.shape[1], c, r))
                        return a3[: Lout // c].reshape(Lout, r)

                    acc = acc.at[:Lout].add(chunk_pass(gtab, stab, swap))
                    if kind == "off":
                        acc = acc.at[:Lout].add(
                            chunk_pass(rowtab, coltab, True))
                return acc

            # 2. fully-local blocks first: consume x_local (indices clamp;
            # padded values are zero), overlapping the ppermutes
            xl_ext = jnp.concatenate(
                [x_local, jnp.zeros((1, r), x_local.dtype)]
            )
            for kind, key, c, vals, rt, ct in groups:
                if key == "loc":
                    acc = consume(acc, kind, c, vals, rt, ct, xl_ext)
            # 3. halo-touching blocks consume [x_local ++ halo]
            for kind, key, c, vals, rt, ct in groups:
                if key == "rem":
                    acc = consume(acc, kind, c, vals, rt, ct, xh)

            # 4. reverse halo exchange: y-halo region back onto owners
            y = acc[:out_per]
            off = out_per
            for d, tab in zip(out_dists, out_send):
                E = tab.shape[1]
                seg = acc[off: off + E * G].reshape(E, G, r)
                off += E * G
                recv = jax.lax.ppermute(seg, axis, rev_perm[d])
                y = (
                    y.reshape(out_per // G, G, r)
                    .at[tab[0]].add(recv)
                    .reshape(out_per, r)
                )
            return y

        return body

    def __repr__(self):
        mt = self._meta
        return (
            f"DistributedBlockOperator(shape={mt.shape}, S={mt.S}, "
            f"sym={mt.sym}, halo_chunks=({mt.Hr},{mt.Hc}))"
        )


def distribute(op: LinearOperator, mesh: Mesh, axis: str = "rows", **kw):
    """Shard ``op`` block-row-wise over ``mesh[axis]``.

    Lazy wrappers are resolved and re-applied on top of the distributed
    base operator, so ``distribute(A.T) @ x == distribute(A).T @ x`` with a
    single on-device copy of A either way.

    ``rhs_axis=`` names a second mesh axis that shards SpMM RHS columns
    (2-D block-rows x RHS-columns mesh): matrix data replicates across it,
    each RHS column group runs its own independent halo ring, and products
    with 2-D ``x`` return outputs sharded over both axes.  SpMV and 1-D
    inputs ignore it.
    """
    base, tr, cj = _resolve(op)
    D = DistributedBlockOperator(base, mesh, axis, **kw)
    if tr and cj:
        return AdjointOperator(D)
    if tr:
        return TransposeOperator(D)
    if cj:
        return ConjOperator(D)
    return D
