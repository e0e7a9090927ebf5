"""Acquisition criteria for Bayesian hyperparameter search.

Reference: photon-lib hyperparameter/criteria/ExpectedImprovement.scala and
ConfidenceBound.scala (PBO eqs. 1-3).
"""
from __future__ import annotations

import numpy as np
from scipy.stats import norm


def expected_improvement(
    best_evaluation: float, maximize: bool = True
):
    """Returns a PredictionTransformation computing E[improvement over
    ``best_evaluation``] under N(mean, var) (reference
    ExpectedImprovement.scala:45-60; always maximized by the search)."""
    direction = 1.0 if maximize else -1.0

    def transform(means: np.ndarray, variances: np.ndarray) -> np.ndarray:
        std = np.sqrt(variances)
        gamma = direction * (means - best_evaluation) / np.maximum(std, 1e-12)
        return std * (gamma * norm.cdf(gamma) + norm.pdf(gamma))

    transform.is_max_opt = True
    return transform


def confidence_bound(exploration_factor: float = 2.0, maximize: bool = True):
    """Upper (maximize) / lower (minimize) confidence bound (reference
    ConfidenceBound.scala:50-70)."""

    def transform(means: np.ndarray, variances: np.ndarray) -> np.ndarray:
        bound = exploration_factor * np.sqrt(variances)
        return means + bound if maximize else means - bound

    transform.is_max_opt = maximize
    return transform
