"""Operations and bytes of the fits, from shapes and the solvers' counters.

The unit is a feature pass, as bench.py counts it: one pass of a solver
over its feature block (a forward X·β or a backward Xᵀr). Each input
byte is counted once per pass, whatever implements the pass; the
elementwise work on the rows (losses, line-search trials) is left out, so
the counts are floors of what the fits need.

- A sparse block of ``nnz`` stored nonzeros over ``rows`` rows and ``dim``
  columns: 2·nnz operations; its column ids and values, the row vector
  and the column vector read or written once,
  nnz·(4 + item) + (rows + dim)·item bytes.
- A lane of a random effect with ``r`` training rows of width ``d``:
  2·r·d operations and r·d·item bytes a pass.
- The windowed Xᵀr kernel's floor: each nonzero's row id, column id and
  value, the row vector read once and the output written once,
  nnz·(8 + item) + (rows + dim)·item bytes (chip_smoke.py's ``bound_ms``
  count less the layout's window ids, which are the layout's, not the
  data's).
"""
from __future__ import annotations


def sparse_pass(nnz: int, rows: int, dim: int, item: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one pass over a sparse block."""
    return 2.0 * nnz, float(nnz * (4 + item) + (rows + dim) * item)


def lane_passes(row_passes_times_d: float, item: int = 4) -> tuple[float, float]:
    """(operations, bytes) of random-effect passes: ``row_passes_times_d``
    is Σ over lanes of passes × training rows × d."""
    return 2.0 * row_passes_times_d, float(row_passes_times_d * item)


def windowed_rmatvec_bytes(nnz: int, rows: int, dim: int, item: int = 4) -> float:
    """The windowed Xᵀr kernel's byte floor for one launch."""
    return float(nnz * (8 + item) + (rows + dim) * item)
