"""Hosmer–Lemeshow goodness-of-fit (calibration) test for logistic models.

Reference: photon-diagnostics hl/HosmerLemeshowDiagnostic.scala:29-94 — bin
samples by predicted probability, compare observed vs expected positives per
bin with a χ² statistic on (non-empty bins − 2) degrees of freedom (the
standard HL test).

The binning is a single weighted histogram over device-computed
probabilities — O(N) with no sort when using fixed-width probability bins
(the reference also uses fixed-width [0,1] deciles).

The port's own copy of photon_tpu/diagnostics/hl.py (host numpy,
no device code): the same statistic for the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class HosmerLemeshowBin:
    lower: float
    upper: float
    count: float  # total weight in bin
    observed_pos: float
    expected_pos: float


@dataclasses.dataclass(frozen=True)
class HosmerLemeshowReport:
    bins: list[HosmerLemeshowBin]
    chi_square: float
    degrees_of_freedom: int
    p_value: float  # P(χ²_df ≥ chi_square): small ⇒ poorly calibrated

    @property
    def well_calibrated(self) -> bool:
        return self.p_value > 0.05


def chi_square_sf(x: float, df: int) -> float:
    """Survival function of the χ² distribution via the regularized upper
    incomplete gamma function (what LAPACK-free reference math reduces to)."""
    if df <= 0:
        return float("nan")
    from scipy.special import gammaincc

    return float(gammaincc(df / 2.0, max(x, 0.0) / 2.0))


def hosmer_lemeshow(
    probabilities: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray | None = None,
    num_bins: int = 10,
) -> HosmerLemeshowReport:
    p = np.asarray(probabilities, dtype=np.float64)
    y = np.asarray(labels, dtype=np.float64)
    w = (
        np.ones_like(p)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )

    edges = np.linspace(0.0, 1.0, num_bins + 1)
    idx = np.clip(np.digitize(p, edges[1:-1]), 0, num_bins - 1)
    count = np.bincount(idx, weights=w, minlength=num_bins)
    observed = np.bincount(idx, weights=w * y, minlength=num_bins)
    expected = np.bincount(idx, weights=w * p, minlength=num_bins)

    # χ² = Σ (O−E)²/E + (O'−E')²/E' over non-empty bins (both outcomes).
    nonempty = count > 0
    chi2 = 0.0
    for b in np.flatnonzero(nonempty):
        e_pos = expected[b]
        e_neg = count[b] - expected[b]
        if e_pos > 1e-12:
            chi2 += (observed[b] - e_pos) ** 2 / e_pos
        if e_neg > 1e-12:
            chi2 += ((count[b] - observed[b]) - e_neg) ** 2 / e_neg

    df = max(int(np.sum(nonempty)) - 2, 1)
    bins = [
        HosmerLemeshowBin(
            lower=float(edges[b]),
            upper=float(edges[b + 1]),
            count=float(count[b]),
            observed_pos=float(observed[b]),
            expected_pos=float(expected[b]),
        )
        for b in range(num_bins)
    ]
    return HosmerLemeshowReport(
        bins=bins,
        chi_square=float(chi2),
        degrees_of_freedom=df,
        p_value=chi_square_sf(float(chi2), df),
    )
