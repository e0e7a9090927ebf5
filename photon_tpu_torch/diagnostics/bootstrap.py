"""Bootstrap training diagnostic: coefficient confidence intervals and
metric distributions from resampled retrains.

Counterpart of photon_tpu/diagnostics/bootstrap.py (reference
photon-diagnostics BootstrapTraining.scala +
bootstrap/BootstrapTrainingDiagnostic.scala:26-145): train the model on B
bootstrap samples of the training set, then report per-coefficient
percentile intervals and the spread of validation metrics.

A bootstrap resample of a weighted dataset is the original dataset with
its weights multiplied by multinomial draw counts, so the feature block
stays resident on the device across all replicates and only the [N]
weight vector changes (the window layout holds no weights and is shared
by every replicate). The counts come from ``np.random.default_rng(seed)``
as in JAX, so both packages retrain on identical weights.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from photon_tpu_torch.diagnostics.fitting import require_layout, reweighted
from photon_tpu_torch.diagnostics.metrics import compute_metrics
from photon_tpu_torch.model_training import train_glm_grid
from photon_tpu_torch.optimize.problem import GLMProblemConfig
from photon_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class CoefficientInterval:
    index: int
    lower: float
    median: float
    upper: float
    point_estimate: float

    @property
    def significant(self) -> bool:
        """Interval excludes zero ⇒ the coefficient's sign is stable."""
        return self.lower > 0.0 or self.upper < 0.0


@dataclasses.dataclass(frozen=True)
class BootstrapReport:
    num_replicates: int
    #: top coefficients by |point estimate|, with percentile intervals
    intervals: list[CoefficientInterval]
    #: metric name → (lower, median, upper) percentiles across replicates
    metric_distributions: dict[str, tuple[float, float, float]]
    #: fraction of reported intervals that straddle zero
    unstable_fraction: float


def bootstrap_diagnostic(
    train_batch,
    validation_batch,
    config: GLMProblemConfig,
    task: TaskType,
    *,
    num_samples: int,
    num_validation_samples: int | None = None,
    num_replicates: int = 16,
    percentile: float = 95.0,
    top_k: int = 20,
    metric_names: Sequence[str] | None = None,
    normalization=None,
    seed: int = 0,
    num_features: int | None = None,
) -> BootstrapReport:
    """Run B reweighted retrains on the batch's device and summarize
    coefficient stability.

    ``num_samples`` is the count of real (non-padding) rows in
    ``train_batch``; multinomial counts are drawn over those rows only so
    padding rows keep weight zero.
    """
    require_layout(train_batch, num_features)
    rng = np.random.default_rng(seed)
    n_total = int(train_batch.labels.shape[0])
    base_weights = train_batch.weights.detach().cpu().numpy().astype(np.float64)
    norm_kw = {} if normalization is None else {"normalization": normalization}
    device = train_batch.labels.device

    # Point estimate on the un-resampled data.
    [point] = train_glm_grid(
        train_batch,
        config,
        [config.regularization_weight],
        warm_start=False,
        num_features=num_features,
        device=device,
        **norm_kw,
    )
    point_means = point.model.coefficients.means.detach().cpu().numpy().astype(np.float64)

    coef_draws = np.zeros((num_replicates, point_means.shape[0]))
    metric_draws: list[dict[str, float]] = []
    warm = point.model.coefficients.means.to(train_batch.labels.dtype)
    for b in range(num_replicates):
        counts = np.zeros(n_total)
        counts[:num_samples] = rng.multinomial(
            num_samples, np.full(num_samples, 1.0 / num_samples)
        )
        replicate = reweighted(train_batch, base_weights * counts)
        [tm] = train_glm_grid(
            replicate,
            config,
            [config.regularization_weight],
            warm_start=False,
            initial_coefficients=warm,
            num_features=num_features,
            device=device,
            **norm_kw,
        )
        coef_draws[b] = tm.model.coefficients.means.detach().cpu().numpy()
        metric_draws.append(
            compute_metrics(
                tm.model,
                validation_batch,
                task,
                num_samples=num_validation_samples,
            )
        )

    lo_q, hi_q = (100.0 - percentile) / 2.0, 100.0 - (100.0 - percentile) / 2.0
    order = np.argsort(-np.abs(point_means))[:top_k]
    intervals = []
    for j in order:
        lo, med, hi = np.percentile(coef_draws[:, j], [lo_q, 50.0, hi_q])
        intervals.append(
            CoefficientInterval(
                index=int(j),
                lower=float(lo),
                median=float(med),
                upper=float(hi),
                point_estimate=float(point_means[j]),
            )
        )

    names = (
        list(metric_names)
        if metric_names is not None
        else sorted(metric_draws[0].keys())
    )
    metric_distributions = {}
    for name in names:
        vals = np.array([m[name] for m in metric_draws])
        lo, med, hi = np.percentile(vals, [lo_q, 50.0, hi_q])
        metric_distributions[name] = (float(lo), float(med), float(hi))

    unstable = sum(1 for iv in intervals if not iv.significant)
    return BootstrapReport(
        num_replicates=num_replicates,
        intervals=intervals,
        metric_distributions=metric_distributions,
        unstable_fraction=unstable / max(len(intervals), 1),
    )
