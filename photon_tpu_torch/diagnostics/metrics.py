"""Full validation-metrics map for one trained GLM.

Counterpart of photon_tpu/diagnostics/metrics.py (reference
photon-diagnostics Evaluation.scala:36-115): MAE/MSE/RMSE on mean
predictions, AUROC/AUPR/peak-F1 for binary classifiers, per-datum
log-likelihood and Akaike information criterion. Margins come from the
model on the batch's device (``compute_margin_batch``), AUC and AUPR from
``evaluation.evaluators.evaluate`` there; the other reductions run on the
host in float64, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.evaluation.evaluators import EvaluatorType, evaluate
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import (
    LogisticLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    SquaredLoss,
)
from photon_tpu_torch.types import TaskType

# Metric-name constants (reference Evaluation.scala MetricsMap keys).
MEAN_ABSOLUTE_ERROR = "MEAN ABSOLUTE ERROR"
MEAN_SQUARED_ERROR = "MEAN SQUARED ERROR"
ROOT_MEAN_SQUARED_ERROR = "ROOT MEAN SQUARED ERROR"
AREA_UNDER_ROC = "AREA UNDER ROC"
AREA_UNDER_PR = "AREA UNDER PRECISION/RECALL"
PEAK_F1 = "PEAK F1"
DATA_LOG_LIKELIHOOD = "PER-DATUM LOG LIKELIHOOD"
AKAIKE_INFORMATION_CRITERION = "AKAIKE INFORMATION CRITERION"

#: Which direction is better, for report rendering / model comparison
#: (reference MetricMetadata).
LARGER_IS_BETTER = {
    MEAN_ABSOLUTE_ERROR: False,
    MEAN_SQUARED_ERROR: False,
    ROOT_MEAN_SQUARED_ERROR: False,
    AREA_UNDER_ROC: True,
    AREA_UNDER_PR: True,
    PEAK_F1: True,
    DATA_LOG_LIKELIHOOD: True,
    AKAIKE_INFORMATION_CRITERION: False,
}


def _host(x, n: int) -> np.ndarray:
    """The first ``n`` rows (device padding dropped) as float64 numpy."""
    return x[:n].detach().cpu().numpy().astype(np.float64)


def _host_loss(loss, margins: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """A pointwise loss of the port evaluated on float64 host arrays."""
    return loss.loss(torch.from_numpy(margins), torch.from_numpy(labels)).numpy()


def peak_f1(scores: np.ndarray, labels: np.ndarray, weights: np.ndarray) -> float:
    """Max F1 over all score thresholds, computed by one descending sweep."""
    order = np.argsort(-scores, kind="stable")
    y = labels[order]
    w = weights[order]
    pos = w * (y > 0.5)
    tp = np.cumsum(pos)
    predicted_pos = np.cumsum(w)
    total_pos = tp[-1] if tp.size else 0.0
    if total_pos <= 0.0:
        return 0.0
    denom = predicted_pos + total_pos  # 2TP + FP + FN = predicted + actual
    f1 = np.where(denom > 0, 2.0 * tp / denom, 0.0)
    return float(np.max(f1))


def log_likelihood(
    task: TaskType,
    margins: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray,
) -> float:
    """Weighted mean per-datum log-likelihood under the task's GLM family
    (float64 host arrays)."""
    margins = np.asarray(margins, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    total_w = float(np.sum(weights))
    if total_w <= 0.0:
        return 0.0
    if task == TaskType.LOGISTIC_REGRESSION:
        ll = -_host_loss(LogisticLoss, margins, labels)
    elif task == TaskType.POISSON_REGRESSION:
        # loss = μ − y·z; full LL adds the −log y! base measure.
        from scipy.special import gammaln

        ll = -_host_loss(PoissonLoss, margins, labels) - gammaln(labels + 1.0)
    elif task == TaskType.LINEAR_REGRESSION:
        # Gaussian LL with σ² set to the observed MSE (the reference's
        # convention for likelihood-of-fit).
        sq = 2.0 * _host_loss(SquaredLoss, margins, labels)
        sigma2 = max(float(np.sum(weights * sq) / total_w), 1e-12)
        ll = -0.5 * (np.log(2.0 * np.pi * sigma2) + sq / sigma2)
    else:
        # Smoothed hinge has no likelihood; report negative loss.
        ll = -_host_loss(SmoothedHingeLoss, margins, labels)
    return float(np.sum(weights * ll) / total_w)


def compute_metrics(
    model: GeneralizedLinearModel,
    batch,
    task: TaskType,
    num_samples: int | None = None,
) -> dict[str, float]:
    """Evaluate one model on one batch (either layout) → metrics map.

    ``num_samples`` trims device padding rows; defaults to the full batch.
    """
    n = num_samples if num_samples is not None else int(batch.labels.shape[0])
    margins_dev = model.compute_margin_batch(batch)
    margins = _host(margins_dev, n)
    means = _host(model.compute_mean(margins_dev), n)
    labels = _host(batch.labels, n)
    weights = _host(batch.weights, n)
    total_w = max(float(np.sum(weights)), 1e-300)

    err = means - labels
    metrics = {
        MEAN_ABSOLUTE_ERROR: float(np.sum(weights * np.abs(err)) / total_w),
        MEAN_SQUARED_ERROR: float(np.sum(weights * err * err) / total_w),
    }
    metrics[ROOT_MEAN_SQUARED_ERROR] = float(np.sqrt(metrics[MEAN_SQUARED_ERROR]))

    if task == TaskType.LOGISTIC_REGRESSION:
        for key, evaluator in ((AREA_UNDER_ROC, EvaluatorType.AUC),
                               (AREA_UNDER_PR, EvaluatorType.AUPR)):
            metrics[key] = float(evaluate(evaluator, margins_dev, batch.labels, batch.weights))
        metrics[PEAK_F1] = peak_f1(margins, labels, weights)

    ll = log_likelihood(task, margins, labels, weights)
    metrics[DATA_LOG_LIKELIHOOD] = ll
    k = int(torch.count_nonzero(model.coefficients.means))
    metrics[AKAIKE_INFORMATION_CRITERION] = 2.0 * k - 2.0 * ll * total_w
    return metrics
