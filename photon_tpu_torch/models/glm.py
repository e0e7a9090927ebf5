"""Generalized linear model classes.

Counterpart of photon_tpu/models/glm.py (reference
GeneralizedLinearModel.scala:33-165 and the four task models): a model is
Coefficients plus a mean (inverse-link) function. Scores are margins;
means apply the link; classifiers add ``predict_class``.
"""
from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.ops.losses import sigmoid
from photon_tpu_torch.ops.objective import matvec
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    coefficients: Coefficients

    task: TaskType = dataclasses.field(init=False, repr=False, default=None)

    def compute_margin(self, features: Tensor, offsets: Tensor | None = None) -> Tensor:
        z = self.coefficients.compute_score(features)
        return z if offsets is None else z + offsets

    def compute_margin_batch(self, batch) -> Tensor:
        """Margins for either batch layout (dense ``LabeledBatch`` or
        sparse-ELL ``SparseBatch``), offsets included, on the batch's
        device."""
        return matvec(batch, self.coefficients.means) + batch.offsets

    def compute_mean(self, margins: Tensor) -> Tensor:
        """Inverse link of the margins; identity by default."""
        return margins

    def predict(self, features: Tensor, offsets: Tensor | None = None) -> Tensor:
        return self.compute_mean(self.compute_margin(features, offsets))

    def update_coefficients(self, coefficients: Coefficients) -> "GeneralizedLinearModel":
        return dataclasses.replace(self, coefficients=coefficients)

    @property
    def model_class_name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class LogisticRegressionModel(GeneralizedLinearModel):
    task = TaskType.LOGISTIC_REGRESSION

    def compute_mean(self, margins: Tensor) -> Tensor:
        return sigmoid(margins)

    def predict_class(self, features: Tensor, threshold: float = 0.5) -> Tensor:
        return (self.predict(features) > threshold).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class LinearRegressionModel(GeneralizedLinearModel):
    task = TaskType.LINEAR_REGRESSION


@dataclasses.dataclass(frozen=True)
class PoissonRegressionModel(GeneralizedLinearModel):
    task = TaskType.POISSON_REGRESSION

    def compute_mean(self, margins: Tensor) -> Tensor:
        return torch.exp(margins)


@dataclasses.dataclass(frozen=True)
class SmoothedHingeLossLinearSVMModel(GeneralizedLinearModel):
    task = TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM

    def predict_class(self, features: Tensor, threshold: float = 0.0) -> Tensor:
        return (self.compute_margin(features) > threshold).to(torch.float32)


_TASK_MODEL = {
    TaskType.LOGISTIC_REGRESSION: LogisticRegressionModel,
    TaskType.LINEAR_REGRESSION: LinearRegressionModel,
    TaskType.POISSON_REGRESSION: PoissonRegressionModel,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLossLinearSVMModel,
}


def model_for_task(task: TaskType, coefficients: Coefficients) -> GeneralizedLinearModel:
    """Task → model class (reference ModelTraining.scala:127-160)."""
    return _TASK_MODEL[task](coefficients=coefficients)
