"""blocksparse: a block-sparse linear-algebra framework in JAX.

A from-scratch JAX/XLA re-design of the capability set of
``BlockSparseMatrices.jl`` (the Julia reference): matrices
that are sparse at the block level, with three formats --

  - :class:`BlockSparseMatrix` -- dense blocks at arbitrary (possibly
    non-contiguous) row/column index lists;
  - :class:`SymmetricBlockMatrix` -- off-diagonal blocks stored once,
    applied twice (as-is and transposed);
  - :class:`VariableBlockCompressedRowStorage` -- CSR-of-blocks with
    variable block sizes and contiguous ranges;

all implementing a LinearMaps-style lazy operator algebra (``@``, ``.T``,
``.H``, 5-arg ``axpby``, composition), jax-pytree-registered so they pass
through ``jit`` / ``grad`` / ``shard_map`` and plug into
``jax.scipy.sparse.linalg`` solvers.

Compute paths: XLA gather/batched-einsum/scatter-add engines (chunk-granular
for contiguous ranges, element-granular otherwise).  Distribution: 1-D
block-row partitioning over a ``jax.sharding.Mesh`` with XLA collectives (see
``blocksparse.parallel``).
"""

from .complexops import ComplexSplitOperator, split_complex
from .api import (
    block,
    colindices,
    colors,
    eachblockindex,
    nnz,
    rowindices,
    transposecolors,
)
from .core import schedule
from .core.layout import BlockLayout, build_layout
from .core.operator import (
    AdjointOperator,
    ComposedOperator,
    ConjOperator,
    LinearOperator,
    ScaledOperator,
    SumOperator,
    TransposeOperator,
)
from .core.schedule import AUTO, COLORED, SERIAL, isserial
from .formats.block_sparse import BlockSparseMatrix
from .formats.symmetric import SymmetricBlockMatrix
from .formats.vbcrs import VariableBlockCompressedRowStorage
from .interop.scipy_io import (
    as_linear_operator,
    from_dense,
    from_scipy_blocks,
    rowcolvals,
    sparse,
    to_scipy,
)
from .interop.bcoo import from_bcoo, to_bcoo
from .interop.serialize import load, save
from .ops.batched import batched_mm, batched_mv
from .interop.viz import blocksummary, show, spy
from .precond import DiagonalOperator, block_jacobi, jacobi
from .solvers import SolveInfo, bicgstab, cg, gmres

__version__ = "0.1.0"

__all__ = [
    "batched_mm",
    "batched_mv",
    "as_linear_operator",
    # formats (export parity: src/BlockSparseMatrices.jl:26-28)
    "BlockSparseMatrix",
    "SymmetricBlockMatrix",
    "VariableBlockCompressedRowStorage",
    # free functions
    "rowindices",
    "colindices",
    "eachblockindex",
    "block",
    "nnz",
    "colors",
    "transposecolors",
    # operator algebra
    "LinearOperator",
    "AdjointOperator",
    "TransposeOperator",
    "ConjOperator",
    "ScaledOperator",
    "SumOperator",
    "ComposedOperator",
    # layout
    "BlockLayout",
    "build_layout",
    # schedules
    "SERIAL",
    "COLORED",
    "AUTO",
    "isserial",
    "schedule",
    # interop / viz
    "rowcolvals",
    "sparse",
    "to_scipy",
    "from_scipy_blocks",
    "from_dense",
    "save",
    "load",
    "split_complex",
    "ComplexSplitOperator",
    "spy",
    "show",
    "blocksummary",
    "to_bcoo",
    "from_bcoo",
    # solvers
    "cg",
    "bicgstab",
    "gmres",
    "SolveInfo",
    # preconditioners
    "jacobi",
    "block_jacobi",
    "DiagonalOperator",
]
