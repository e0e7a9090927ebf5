"""Dataset-wide evaluators, on the tensors' device.

Counterpart of photon_tpu/evaluation/evaluators.py (reference
Evaluator.scala:26, EvaluatorType.scala): AUC as the rank statistic
(Mann-Whitney, ties given their average rank), AUPR as average precision,
RMSE and the summed loss metrics. ``weights`` masks rows: a row of weight
0 (padding) takes no part; the loss metrics and RMSE weight by it.
"""
from __future__ import annotations

import enum

import torch

from photon_tpu_torch.ops.losses import (
    POSITIVE_RESPONSE_THRESHOLD,
    LogisticLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    SquaredLoss,
)

Tensor = torch.Tensor


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    AUPR = "AUPR"
    RMSE = "RMSE"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"

    @property
    def larger_is_better(self) -> bool:
        """Model-selection direction (reference Evaluator.betterThan)."""
        return self in (EvaluatorType.AUC, EvaluatorType.AUPR)


def _masked(weights: Tensor | None, scores: Tensor) -> Tensor:
    return torch.ones_like(scores) if weights is None else weights


def average_ranks(x: Tensor) -> Tensor:
    """1-based ranks, ties given their average rank."""
    order = torch.argsort(x, stable=True)
    sorted_x = x[order]
    ranks = torch.arange(1, x.shape[0] + 1, dtype=x.dtype, device=x.device)
    first = torch.searchsorted(sorted_x, sorted_x, side="left")
    last = torch.searchsorted(sorted_x, sorted_x, side="right") - 1
    out = torch.empty_like(sorted_x)
    out[order] = (ranks[first] + ranks[last]) / 2.0
    return out


def area_under_roc_curve(scores: Tensor, labels: Tensor, weights: Tensor | None = None) -> Tensor:
    """AUROC by the rank statistic; 0.5 when a class is missing."""
    w = _masked(weights, scores)
    pos = (labels > POSITIVE_RESPONSE_THRESHOLD) & (w > 0)
    neg = (labels <= POSITIVE_RESPONSE_THRESHOLD) & (w > 0)
    n_pos, n_neg = pos.sum(), neg.sum()
    # masked rows rank below every real score, and their rank mass is taken
    # out again below
    r = average_ranks(torch.where(w > 0, scores, torch.full_like(scores, -torch.inf)))
    sum_pos_ranks = torch.where(pos, r, torch.zeros_like(r)).sum()
    n_masked = (w <= 0).sum()
    auc = (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0 - n_pos * n_masked) / torch.clamp(
        n_pos * n_neg, min=1
    )
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, 0.5))


def area_under_pr_curve(scores: Tensor, labels: Tensor, weights: Tensor | None = None) -> Tensor:
    """Average precision (the step-interpolated area under the PR curve)."""
    w = _masked(weights, scores)
    valid = w > 0
    pos = (labels > POSITIVE_RESPONSE_THRESHOLD) & valid
    order = torch.argsort(
        torch.where(valid, -scores, torch.full_like(scores, torch.inf)), stable=True
    )
    pos_sorted = pos[order].to(scores.dtype)
    tp = torch.cumsum(pos_sorted, 0)
    seen = torch.cumsum(valid[order].to(scores.dtype), 0)
    precision = tp / torch.clamp(seen, min=1.0)
    n_pos = pos.sum()
    ap = (precision * pos_sorted).sum() / torch.clamp(n_pos, min=1)
    return torch.where(n_pos > 0, ap, torch.zeros_like(ap))


def _weighted_mean(values: Tensor, weights: Tensor) -> Tensor:
    return (weights * values).sum() / torch.clamp(weights.sum(), min=1e-12)


def rmse(scores: Tensor, labels: Tensor, weights: Tensor | None = None) -> Tensor:
    return torch.sqrt(_weighted_mean(torch.square(scores - labels), _masked(weights, scores)))


def squared_loss_metric(scores, labels, weights=None):
    return (_masked(weights, scores) * SquaredLoss.loss(scores, labels)).sum()


def logistic_loss_metric(scores, labels, weights=None):
    return (_masked(weights, scores) * LogisticLoss.loss(scores, labels)).sum()


def poisson_loss_metric(scores, labels, weights=None):
    return (_masked(weights, scores) * PoissonLoss.loss(scores, labels)).sum()


def smoothed_hinge_loss_metric(scores, labels, weights=None):
    return (_masked(weights, scores) * SmoothedHingeLoss.loss(scores, labels)).sum()


_EVALUATORS = {
    EvaluatorType.AUC: area_under_roc_curve,
    EvaluatorType.AUPR: area_under_pr_curve,
    EvaluatorType.RMSE: rmse,
    EvaluatorType.LOGISTIC_LOSS: logistic_loss_metric,
    EvaluatorType.POISSON_LOSS: poisson_loss_metric,
    EvaluatorType.SQUARED_LOSS: squared_loss_metric,
    EvaluatorType.SMOOTHED_HINGE_LOSS: smoothed_hinge_loss_metric,
}


def evaluate(
    evaluator: EvaluatorType, scores: Tensor, labels: Tensor, weights: Tensor | None = None
) -> Tensor:
    """``scores`` are margins (x·w + offset), as the reference's
    evaluators take them."""
    return _EVALUATORS[evaluator](scores, labels, weights)
