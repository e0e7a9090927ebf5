"""Prediction-error independence diagnostic via the Kendall-τ rank test.

Reference: photon-diagnostics independence/KendallTauAnalysis.scala +
PredictionErrorIndependenceDiagnostic.scala:27 — test whether prediction
errors are rank-correlated with the predictions themselves (a symptom of
model misspecification) using τ-b with the normal approximation z-score.

Implementation: vectorized O(n²) sign-outer-product on a bounded subsample
(the test's power saturates long before n² matters; the reference likewise
computes τ on collected local arrays, not distributed).

The port's own copy of photon_tpu/diagnostics/independence.py (host numpy,
no device code): the same statistic for the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class KendallTauReport:
    tau: float  # τ-b in [-1, 1]
    z_score: float
    p_value: float  # two-sided, normal approximation
    num_samples: int
    num_concordant: int
    num_discordant: int

    @property
    def errors_independent(self) -> bool:
        return self.p_value > 0.05


def _normal_sf(z: float) -> float:
    from scipy.special import erfc

    return 0.5 * float(erfc(z / np.sqrt(2.0)))


def kendall_tau(
    a: np.ndarray,
    b: np.ndarray,
    max_samples: int = 2000,
    seed: int = 0,
) -> KendallTauReport:
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    n = a.shape[0]
    if n > max_samples:
        idx = np.random.default_rng(seed).choice(n, max_samples, replace=False)
        a, b = a[idx], b[idx]
        n = max_samples

    sa = np.sign(a[:, None] - a[None, :])
    sb = np.sign(b[:, None] - b[None, :])
    prod = sa * sb
    iu = np.triu_indices(n, k=1)
    concordant = int(np.sum(prod[iu] > 0))
    discordant = int(np.sum(prod[iu] < 0))

    n0 = n * (n - 1) // 2
    # Tie corrections (τ-b): pairs tied in a, in b.
    t_a = int(np.sum(sa[iu] == 0))
    t_b = int(np.sum(sb[iu] == 0))
    denom = np.sqrt(float(n0 - t_a) * float(n0 - t_b))
    tau = (concordant - discordant) / denom if denom > 0 else 0.0

    # Normal approximation for the null distribution of τ.
    if n >= 3:
        sigma = np.sqrt(2.0 * (2.0 * n + 5.0) / (9.0 * n * (n - 1.0)))
        z = tau / sigma
    else:
        z = 0.0
    p = 2.0 * _normal_sf(abs(z))
    return KendallTauReport(
        tau=float(tau),
        z_score=float(z),
        p_value=min(p, 1.0),
        num_samples=n,
        num_concordant=concordant,
        num_discordant=discordant,
    )


def prediction_error_independence(
    predictions: np.ndarray,
    labels: np.ndarray,
    max_samples: int = 2000,
    seed: int = 0,
) -> KendallTauReport:
    """τ test between predictions and (label − prediction) errors."""
    predictions = np.asarray(predictions, dtype=np.float64)
    errors = np.asarray(labels, dtype=np.float64) - predictions
    return kendall_tau(predictions, errors, max_samples=max_samples, seed=seed)
