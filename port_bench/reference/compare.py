"""The numbers the harness compares, each between a program output and the
reference's (host float64 arrays)."""
from __future__ import annotations

import numpy as np


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """‖got − want‖ / ‖want‖ (1 when the shapes differ: no answer)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return 1.0
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def worst_row_gap(got: np.ndarray, want: np.ndarray) -> float:
    """max over rows of |got − want| / (1 + |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def zero_mismatch(got: np.ndarray, want: np.ndarray) -> float:
    """The share of coefficients that are exactly zero on one side only."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return 1.0
    return float(np.mean((got == 0) != (want == 0)))


def rel_gap(got: float, want: float) -> float:
    """|got − want| / |want|."""
    return float(abs(got - want) / max(abs(want), 1e-300))


def path_gaps(got, want) -> np.ndarray:
    """|got − want| / |want| of an objective after each iteration 1, 2, …
    of the longer path; a path that stopped earlier keeps its last value,
    as the solvers pad their own."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = max(len(got), len(want))
    got, want = (np.concatenate([p, np.full(n - len(p), p[-1])]) for p in (got, want))
    return np.abs(got[1:] - want[1:]) / np.abs(want[1:])


def path_gap(got, want) -> float:
    """The worst of :func:`path_gaps` (1 without a path: no answer)."""
    return 1.0 if got is None else float(np.max(path_gaps(got, want)))
