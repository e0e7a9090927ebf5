"""Operations and bytes of a single-GLM OWL-QN fit, from its shape and the
solver's own counts (the floors of ``work.py``: each input byte once per
pass, the elementwise work on the rows left out).

- Each feature pass over the sparse block (a trial's forward X·x, the
  accepted point's backward Xᵀr, the start's evaluations) is
  ``work.sparse_pass``; the solver counts them (``n_feature_passes``).
- The two-loop recursion of iteration i runs over min(i, m) pairs of
  [D] vectors: in each loop a dot and an axpy per pair, 8·D operations a
  pair in all, and each of the pair's two vectors read once in each loop,
  4·D·item bytes a pair.
"""
from __future__ import annotations

from port_bench.counts import work


def pairs_used(iterations: int, m: int) -> int:
    """Σ over iterations 0 … iterations − 1 of min(i, m): the pairs the
    two-loop recursion runs over, each iteration adding at most one."""
    return sum(min(i, m) for i in range(iterations))


def fit_work(nnz: int, rows: int, dim: int, *, passes: int, iterations: int, m: int,
             item: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one fit."""
    flops, nbytes = work.sparse_pass(nnz, rows, dim, item)
    pairs = pairs_used(iterations, m)
    return (passes * flops + 8.0 * dim * pairs,
            passes * nbytes + 4.0 * dim * item * pairs)
