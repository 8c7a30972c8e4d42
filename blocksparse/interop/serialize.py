"""Serialization: save/load block operators to a single .npz file.

The reference has no checkpointing (JLD2 fixtures only, SURVEY.md §5); this
is the convenience layer: formats are pytrees, so persisting the host-side
construction data (blocks + index lists + settings) round-trips exactly.
The stored representation is construction-level, not bucket-level, so files
survive layout-engine changes.
"""

from __future__ import annotations

import numpy as np

from ..formats.block_sparse import BlockSparseMatrix
from ..formats.symmetric import SymmetricBlockMatrix
from ..formats.vbcrs import VariableBlockCompressedRowStorage
from ..ops.dispatch import BACKENDS

__all__ = ["save", "load"]

_FORMATS = {
    "BlockSparseMatrix": BlockSparseMatrix,
    "SymmetricBlockMatrix": SymmetricBlockMatrix,
    "VariableBlockCompressedRowStorage": VariableBlockCompressedRowStorage,
}


def _pack_ragged(prefix: str, arrays, out: dict):
    out[f"{prefix}_count"] = np.int64(len(arrays))
    for i, a in enumerate(arrays):
        out[f"{prefix}_{i}"] = np.asarray(a)


def _unpack_ragged(prefix: str, data) -> list[np.ndarray]:
    n = int(data[f"{prefix}_count"])
    return [data[f"{prefix}_{i}"] for i in range(n)]


def save(path, op) -> None:
    """Save a block operator (any of the three formats) to ``path`` (.npz)."""
    kind = type(op).__name__
    if kind not in _FORMATS:
        raise TypeError(
            f"save supports the three storage formats, got {kind} "
            "(materialize lazy wrappers or save the base operator)"
        )
    meta = dict(
        kind=kind,
        shape=np.asarray(op.shape, dtype=np.int64),
        schedule=np.str_(op.schedule),
        # Construction settings round-trip exactly (still overridable at load).
        backend=np.str_(op._backend),
        precision=np.str_(op._precision if op._precision is not None else "none"),
        granularity=np.str_(repr(op._granularity)),
        scatter=np.str_(getattr(op, "_scatter", "atomic")),
    )
    if isinstance(op, SymmetricBlockMatrix):
        _pack_ragged("diag", [op.diagonal(i) for i in range(op.ndiagonals)], meta)
        _pack_ragged(
            "diagidx", [op.diagonalindices(i) for i in range(op.ndiagonals)], meta
        )
        _pack_ragged(
            "off", [op.offdiagonal(i) for i in range(op.noffdiagonals)], meta
        )
        _pack_ragged(
            "rows", [op.blockrowindices(i) for i in range(op.noffdiagonals)], meta
        )
        _pack_ragged(
            "cols", [op.blockcolindices(i) for i in range(op.noffdiagonals)], meta
        )
    else:
        n = op.nblocks
        _pack_ragged("blocks", [op.block(i) for i in range(n)], meta)
        _pack_ragged("rows", [op.blockrowindices(i) for i in range(n)], meta)
        _pack_ragged("cols", [op.blockcolindices(i) for i in range(n)], meta)
    np.savez_compressed(path, **meta)


def load(path, **overrides):
    """Load an operator saved by :func:`save`.  ``overrides`` are passed to
    the constructor (e.g. ``backend=``, ``granularity=``, ``precision=``).

    Files from earlier versions may carry ``optimize`` and ``autotune``
    fields and engine names that no longer exist; they chose engines, not
    results, so they are ignored and such a backend loads as "auto"."""
    import ast

    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"])
        shape = tuple(int(v) for v in data["shape"])
        kwargs = dict(schedule=str(data["schedule"]))
        if "backend" in data:  # settings block (absent in round-1 files)
            backend = str(data["backend"])
            kwargs["backend"] = backend if backend in BACKENDS else "auto"
            prec = str(data["precision"])
            kwargs["precision"] = None if prec == "none" else prec
            gran = str(data["granularity"])
            kwargs["granularity"] = "pow2" if gran == "'pow2'" else ast.literal_eval(gran)
            if kind != "SymmetricBlockMatrix":
                kwargs["scatter"] = str(data["scatter"])
        kwargs.update(overrides)
        if kind == "SymmetricBlockMatrix":
            op = SymmetricBlockMatrix(
                _unpack_ragged("diag", data),
                _unpack_ragged("diagidx", data),
                _unpack_ragged("off", data),
                _unpack_ragged("rows", data),
                _unpack_ragged("cols", data),
                shape,
                **kwargs,
            )
        else:
            cls = _FORMATS[kind]
            op = cls(
                _unpack_ragged("blocks", data),
                _unpack_ragged("rows", data),
                _unpack_ragged("cols", data),
                shape,
                **kwargs,
            )
    return op
