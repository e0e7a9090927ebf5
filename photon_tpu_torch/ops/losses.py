"""Pointwise GLM losses with first and second margin derivatives.

Counterpart of photon_tpu/ops/losses.py. Each loss is a set of elementwise
tensor functions of the margin ``z`` and label ``y``; "positive" means
y > 0.5. ``sigmoid`` and ``log1p_exp`` only ever exponentiate a
non-positive argument, so neither tail overflows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_tpu_torch.types import TaskType

POSITIVE_RESPONSE_THRESHOLD = 0.5

Tensor = torch.Tensor


def log1p_exp(z: Tensor) -> Tensor:
    """log(1 + exp(z)) = max(z, 0) + log1p(exp(-|z|))."""
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def sigmoid(z: Tensor) -> Tensor:
    e = torch.exp(-torch.abs(z))
    return torch.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    twice_diff: bool = True

    def loss_and_d1(self, z: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
        return self.loss(z, y), self.d1(z, y)


def _logistic_loss(z, y):
    return torch.where(
        y > POSITIVE_RESPONSE_THRESHOLD, log1p_exp(-z), log1p_exp(z)
    )


def _logistic_d1(z, y):
    return torch.where(
        y > POSITIVE_RESPONSE_THRESHOLD, -sigmoid(-z), sigmoid(z)
    )


def _logistic_d2(z, y):
    s = sigmoid(z)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss(
    name="logistic", loss=_logistic_loss, d1=_logistic_d1, d2=_logistic_d2
)

SquaredLoss = PointwiseLoss(
    name="squared",
    loss=lambda z, y: 0.5 * (z - y) * (z - y),
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
)

PoissonLoss = PointwiseLoss(
    name="poisson",
    loss=lambda z, y: torch.exp(z) - y * z,
    d1=lambda z, y: torch.exp(z) - y,
    d2=lambda z, y: torch.exp(z),
)


def _hinge_t(z, y):
    y_signed = torch.where(y > POSITIVE_RESPONSE_THRESHOLD, 1.0, -1.0).to(
        z.dtype
    )
    return y_signed * z, y_signed


def _smoothed_hinge_loss(z, y):
    # Rennie's smoothed hinge: 0.5 − t (t ≤ 0), ½(1 − t)² (0 < t < 1), 0
    t, _ = _hinge_t(z, y)
    quad = 0.5 * torch.square(1.0 - t)
    zero = torch.zeros_like(t)
    return torch.where(t <= 0.0, 0.5 - t, torch.where(t < 1.0, quad, zero))


def _smoothed_hinge_d1(z, y):
    t, y_signed = _hinge_t(z, y)
    zero = torch.zeros_like(t)
    dt = torch.where(
        t <= 0.0, -torch.ones_like(t), torch.where(t < 1.0, t - 1.0, zero)
    )
    return dt * y_signed


def _smoothed_hinge_d2(z, y):
    t, _ = _hinge_t(z, y)
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


SmoothedHingeLoss = PointwiseLoss(
    name="smoothed_hinge",
    loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    twice_diff=False,
)

_TASK_LOSS = {
    TaskType.LOGISTIC_REGRESSION: LogisticLoss,
    TaskType.LINEAR_REGRESSION: SquaredLoss,
    TaskType.POISSON_REGRESSION: PoissonLoss,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    return _TASK_LOSS[task]
