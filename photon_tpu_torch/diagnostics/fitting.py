"""Fitting (learning-curve) diagnostic: train/test metrics vs training-set
fraction.

Counterpart of photon_tpu/diagnostics/fitting.py (reference
photon-diagnostics fitting/FittingDiagnostic.scala:33-128): train on
growing prefixes of the training data and plot train vs holdout metric
curves; a widening gap diagnoses overfitting, twin high plateaus diagnose
underfitting.

"Training on a fraction" is weight-masking a fixed random permutation
prefix, so every fraction retrains on the same resident batch with only
its ``weights`` replaced (a window layout, which holds no weights, rides
along and every gradient runs the windowed Xᵀr kernel on the card). The
permutation comes from ``np.random.default_rng(seed)`` as in JAX, so both
packages retrain on identical weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.diagnostics.metrics import compute_metrics
from photon_tpu_torch.model_training import train_glm_grid
from photon_tpu_torch.ops.sparse_windows import windows_wanted
from photon_tpu_torch.optimize.problem import GLMProblemConfig
from photon_tpu_torch.types import SparseBatch, TaskType


@dataclasses.dataclass(frozen=True)
class FittingReport:
    fractions: list[float]
    #: metric name → per-fraction value on the (masked) training portion
    train_metrics: dict[str, list[float]]
    #: metric name → per-fraction value on the holdout set
    test_metrics: dict[str, list[float]]


def require_layout(batch, num_features: int | None) -> None:
    """A retrain batch must carry the window layout wherever the policy
    builds one (a sparse batch on the card at d ≥ 1024): its gradients
    then run the windowed kernel, never the flat scatter."""
    if (
        isinstance(batch, SparseBatch)
        and batch.windows is None
        and windows_wanted(batch.labels.device, num_features or 0)
    ):
        raise ValueError(
            "a sparse retrain batch on the card at d ≥ 1024 needs its window layout "
            "(build it with to_device_sparse_batch / to_device_auto_batch)"
        )


def reweighted(batch, weights: np.ndarray):
    """``batch`` with its row weights replaced (host float64 → the batch's
    weight type and device); every other field, the window layout
    included, is the same object."""
    w = torch.as_tensor(weights).to(device=batch.weights.device, dtype=batch.weights.dtype)
    return batch._replace(weights=w)


def fitting_diagnostic(
    train_batch,
    test_batch,
    config: GLMProblemConfig,
    task: TaskType,
    *,
    num_samples: int,
    num_test_samples: int | None = None,
    fractions: list[float] | None = None,
    normalization=None,
    seed: int = 0,
    num_features: int | None = None,
) -> FittingReport:
    """Retrain on growing weight-masked fractions of ``train_batch`` (each
    fit warm-started from the previous one) on the batch's device."""
    require_layout(train_batch, num_features)
    fractions = fractions or [0.25, 0.5, 0.75, 1.0]
    norm_kw = {} if normalization is None else {"normalization": normalization}
    rng = np.random.default_rng(seed)
    n_total = int(train_batch.labels.shape[0])
    perm = rng.permutation(num_samples)
    base_weights = train_batch.weights.detach().cpu().numpy().astype(np.float64)

    train_metrics: dict[str, list[float]] = {}
    test_metrics: dict[str, list[float]] = {}
    warm = None
    for frac in fractions:
        take = max(int(round(frac * num_samples)), 1)
        mask = np.zeros(n_total)
        mask[perm[:take]] = 1.0
        masked = reweighted(train_batch, base_weights * mask)
        [tm] = train_glm_grid(
            masked,
            config,
            [config.regularization_weight],
            warm_start=False,
            initial_coefficients=warm,
            num_features=num_features,
            device=train_batch.labels.device,
            **norm_kw,
        )
        warm = tm.model.coefficients.means.to(train_batch.labels.dtype)
        on_train = compute_metrics(tm.model, masked, task, num_samples=n_total)
        on_test = compute_metrics(tm.model, test_batch, task, num_samples=num_test_samples)
        for name, v in on_train.items():
            train_metrics.setdefault(name, []).append(v)
        for name, v in on_test.items():
            test_metrics.setdefault(name, []).append(v)

    return FittingReport(
        fractions=list(fractions),
        train_metrics=train_metrics,
        test_metrics=test_metrics,
    )
