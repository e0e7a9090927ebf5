"""GLM problems: objective + L-BFGS + L2 regularization.

Counterpart of photon_tpu/optimize/problem.py, L-BFGS only. One
``GLMProblem`` solves a whole-dataset batch (fixed effect) or a lane
batch of independent per-entity problems (random effect) alike.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optimize.common import OptimizeResult, OptimizerConfig
from photon_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_tpu_torch.types import OptimizerType, TaskType


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L2 = "L2"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    regularization_type: RegularizationType = RegularizationType.NONE

    def l2_weight(self, reg_weight: float) -> float:
        if self.regularization_type == RegularizationType.L2:
            return reg_weight
        return 0.0


@dataclasses.dataclass(frozen=True)
class GLMProblemConfig:
    task: TaskType = TaskType.LOGISTIC_REGRESSION
    optimizer: OptimizerType = OptimizerType.LBFGS
    optimizer_config: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = RegularizationContext()
    regularization_weight: float = 0.0

    def __post_init__(self):
        if self.optimizer not in (OptimizerType.LBFGS,):
            raise NotImplementedError(
                f"optimizer {self.optimizer.name} is not ported yet (L-BFGS only)"
            )

    def with_regularization_weight(self, w: float) -> "GLMProblemConfig":
        return dataclasses.replace(self, regularization_weight=w)


@dataclasses.dataclass(frozen=True)
class GLMProblem:
    config: GLMProblemConfig
    objective: GLMObjective

    @staticmethod
    def build(
        config: GLMProblemConfig,
        normalization: NormalizationContext = NormalizationContext(),
    ) -> "GLMProblem":
        objective = GLMObjective(
            loss=loss_for_task(config.task),
            l2_weight=config.regularization.l2_weight(config.regularization_weight),
            normalization=normalization,
        )
        return GLMProblem(config=config, objective=objective)

    def solve(
        self, batch, w0: torch.Tensor, *, extra_offsets: torch.Tensor | None = None
    ) -> OptimizeResult:
        """L-BFGS with the margin-space line search. ``extra_offsets`` (the
        coordinate-descent residual) is folded into the batch offsets."""
        if extra_offsets is not None:
            batch = batch._replace(offsets=batch.offsets + extra_offsets)
        return minimize_lbfgs(
            None,
            w0,
            self.config.optimizer_config,
            oracle=self.objective.directional_oracle(batch),
        )
