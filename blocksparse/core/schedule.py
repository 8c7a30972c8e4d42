"""Execution-plan ("scheduler") abstraction.

Parity target: the reference stores an OhMyThreads scheduler *in the matrix*
(blockmatrix.jl:33) and gates coloring on ``isserial`` (blockmatrix.jl:91,
BlockSparseMatrices.jl:12-18).  The analog here: the schedule choice is data
carried by the operator and selects the execution plan:

  SERIAL   -- one color containing every block; single sequential plan
              (parity: SerialScheduler -> ``colors = [eachindex(blocks)]``,
              blockmatrix.jl:92).  Element buckets run deterministic
              scatter-add.
  COLORED  -- conflict-free colored rounds (parity: DynamicScheduler +
              WorkstreamDSATUR coloring).  Selects genuinely different
              compiled programs: the element engine may run the
              scatter-free colored gather rounds (ops/colored.py, auto
              cost-gated), whose correctness DEPENDS on the coloring
              invariant -- a wrong coloring corrupts results
              (tests/test_colored.py), which is what makes the
              serial-vs-colored duality test the analog of the
              reference's 1-thread-vs-5-thread CI check.
"""

from __future__ import annotations

__all__ = ["SERIAL", "COLORED", "AUTO", "isserial", "normalize_schedule"]

SERIAL = "serial"
COLORED = "colored"
AUTO = "auto"

_VALID = (SERIAL, COLORED, AUTO)


def normalize_schedule(s: str) -> str:
    if s not in _VALID:
        raise ValueError(f"unknown schedule {s!r}; expected one of {_VALID}")
    return s


def isserial(s: str) -> bool:
    """Parity: ``isserial(::Scheduler)`` (BlockSparseMatrices.jl:12-18)."""
    return s == SERIAL
