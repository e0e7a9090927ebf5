"""GLM problems: objective + optimizer + regularization + variances.

Counterpart of photon_tpu/optimize/problem.py (reference
GeneralizedLinearOptimizationProblem, DistributedOptimizationProblem:
per-λ weight :62-73, variances :82-96, down-sampling :145-160,
RegularizationContext, OptimizerFactory, VarianceComputationType). One
``GLMProblem`` solves a whole-dataset batch (fixed effect, single GLM) or
a lane batch of independent per-entity problems (random effect) alike,
with every optimizer: L-BFGS (L-BFGS-B with box bounds in the config),
TRON and OWL-QN.
"""
from __future__ import annotations

import dataclasses
import enum
import os

import torch

from photon_tpu_torch.data.sampling import build_down_sampler
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optimize import solo_lbfgs
from photon_tpu_torch.optimize.common import OptimizeResult, OptimizerConfig
from photon_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_tpu_torch.optimize.owlqn import minimize_owlqn
from photon_tpu_torch.optimize.tron import minimize_tron
from photon_tpu_torch.parallel.mesh import LOCAL
from photon_tpu_torch.types import OptimizerType, TaskType


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """L1/L2 mixing: ELASTIC_NET with mixing α (0.5 when unset) gives
    l1 = α·λ and l2 = (1−α)·λ."""

    regularization_type: RegularizationType = RegularizationType.NONE
    elastic_net_alpha: float | None = None

    def __post_init__(self):
        if (
            self.regularization_type == RegularizationType.ELASTIC_NET
            and self.elastic_net_alpha is not None
            and not (0.0 <= self.elastic_net_alpha <= 1.0)
        ):
            raise ValueError("elastic net alpha must be in [0, 1]")

    def _alpha(self) -> float:
        return 0.5 if self.elastic_net_alpha is None else self.elastic_net_alpha

    def l1_weight(self, reg_weight: float) -> float:
        if self.regularization_type == RegularizationType.L1:
            return reg_weight
        if self.regularization_type == RegularizationType.ELASTIC_NET:
            return self._alpha() * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.regularization_type == RegularizationType.L2:
            return reg_weight
        if self.regularization_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self._alpha()) * reg_weight
        return 0.0


class VarianceComputationType(enum.Enum):
    """NONE; SIMPLE: 1/diag(H); FULL: diag(H⁻¹) by Cholesky."""

    NONE = "NONE"
    SIMPLE = "SIMPLE"
    FULL = "FULL"


@dataclasses.dataclass(frozen=True)
class GLMProblemConfig:
    task: TaskType = TaskType.LOGISTIC_REGRESSION
    optimizer: OptimizerType = OptimizerType.LBFGS
    optimizer_config: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = RegularizationContext()
    regularization_weight: float = 0.0
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    down_sampling_rate: float = 1.0

    def with_regularization_weight(self, w: float) -> "GLMProblemConfig":
        return dataclasses.replace(self, regularization_weight=w)


def full_line_search() -> bool:
    """``PHOTON_GLM_LINESEARCH=full``: OWL-QN and L-BFGS(-B) take black-box
    trials, a full value and gradient each, instead of the margin-space
    line search. Read at each solve, as JAX reads it."""
    return os.environ.get("PHOTON_GLM_LINESEARCH", "margin").strip().lower() == "full"


def _untouched(cfg: OptimizerConfig) -> bool:
    """Every field at its default (bounds unset): TRON then runs with its
    own defaults. Compared field by field, since bounds may be arrays."""
    d = OptimizerConfig()
    return not cfg.has_box and all(
        getattr(cfg, f.name) == getattr(d, f.name)
        for f in dataclasses.fields(OptimizerConfig)
        if f.name not in ("lower_bounds", "upper_bounds")
    )


@dataclasses.dataclass(frozen=True)
class GLMProblem:
    config: GLMProblemConfig
    objective: GLMObjective

    @staticmethod
    def build(
        config: GLMProblemConfig,
        normalization: NormalizationContext = NormalizationContext(),
        mesh=LOCAL,
    ) -> "GLMProblem":
        """Raises ``ValueError`` where the reference refuses the pair: TRON
        with a loss that is not twice differentiable, and L1 with an
        optimizer other than L-BFGS or OWL-QN. ``mesh``: the batch is this
        rank's rows of a row-sharded fixed effect (ops/objective.py)."""
        loss = loss_for_task(config.task)
        if config.optimizer == OptimizerType.TRON and not loss.twice_diff:
            raise ValueError(
                f"TRON requires a twice-differentiable loss; {loss.name} is not "
                "(reference restricts smoothed hinge to LBFGS/OWLQN)"
            )
        l1 = config.regularization.l1_weight(config.regularization_weight)
        l2 = config.regularization.l2_weight(config.regularization_weight)
        if l1 > 0 and config.optimizer not in (OptimizerType.LBFGS, OptimizerType.OWLQN):
            raise ValueError("L1/elastic-net requires OWLQN")
        objective = GLMObjective(
            loss=loss, l2_weight=l2, l1_weight=l1, normalization=normalization, mesh=mesh
        )
        return GLMProblem(config=config, objective=objective)

    def solver_reason(self) -> str | None:
        """What in this problem itself keeps its L-BFGS solves off the
        hand-written kernels of ``csrc/lane_lbfgs.cu``, whatever their
        data, or None: the kernels compute L-BFGS (or L-BFGS-B without
        bounds) with L2 or no regularization, no box, no normalization, on
        the margin line search. Both dispatch rules,
        ``lane_lbfgs.plain_loop_reason`` and
        ``solo_lbfgs.plain_loop_reason``, ask it first."""
        cfg = self.config
        norm = self.objective.normalization
        if full_line_search():
            return "full line search"
        if cfg.optimizer not in (OptimizerType.LBFGS, OptimizerType.LBFGSB):
            return f"optimizer {cfg.optimizer.value}"
        if cfg.regularization.regularization_type not in (RegularizationType.NONE,
                                                          RegularizationType.L2):
            return f"regularization {cfg.regularization.regularization_type.value}"
        if cfg.optimizer_config.has_box:
            return "box bounds"
        if norm.shifts is not None or norm.factors is not None:
            return "normalization"
        return None

    def objective_for_weight(self, reg_weight) -> GLMObjective:
        """The objective with l1/l2 recomputed from λ (None: as built)."""
        if reg_weight is None:
            return self.objective
        return dataclasses.replace(
            self.objective,
            l1_weight=self.config.regularization.l1_weight(reg_weight),
            l2_weight=self.config.regularization.l2_weight(reg_weight),
        )

    def solve(
        self,
        batch,
        w0: torch.Tensor,
        reg_weight=None,
        *,
        extra_offsets: torch.Tensor | None = None,
    ) -> OptimizeResult:
        """Run the configured optimizer. ``extra_offsets`` (the
        coordinate-descent residual) is folded into the batch offsets.

        L1 or elastic net (or OWLQN) runs OWL-QN with value-only trials
        and the accepted gradient from carried margins; TRON runs with the
        curvature pass hoisted out of its CG loop; L-BFGS and L-BFGS-B run
        with the margin-space line search (:func:`full_line_search`: with
        black-box trials).

        An L-BFGS(-B) solve of one lane (``w0`` [D]) runs its iterations on
        the card's fused kernels where ``solo_lbfgs.plain_loop_reason``
        finds nothing against it, else the plain loop; each such solve is
        recorded by its route (``cuda_build.record_route``: the tally
        ``lbfgs.solo_fused`` or ``lbfgs.solo_plain`` on the registry,
        telemetry on or off)."""
        if extra_offsets is not None:
            batch = batch._replace(offsets=batch.offsets + extra_offsets)
        cfg = self.config.optimizer_config
        objective = self.objective_for_weight(reg_weight)
        opt = self.config.optimizer
        has_l1 = self.config.regularization.regularization_type in (
            RegularizationType.L1,
            RegularizationType.ELASTIC_NET,
        )
        full_ls = full_line_search()
        vg = lambda w: objective.value_and_gradient(w, batch)  # noqa: E731
        if has_l1 or opt == OptimizerType.OWLQN:
            if full_ls:
                return minimize_owlqn(vg, w0, objective.l1_weight, cfg)
            return minimize_owlqn(
                None, w0, objective.l1_weight, cfg,
                oracle=objective.smooth_margin_oracle(batch),
            )
        if opt == OptimizerType.TRON:
            if _untouched(cfg):
                cfg = cfg.tron_defaults()
            return minimize_tron(
                vg,
                None,
                w0,
                cfg,
                hvp_factory=lambda w: objective.hessian_operator(w, batch),
            )
        if w0.dim() == 1:
            reason = solo_lbfgs.plain_loop_reason(self, batch, w0)
            if cuda_build.record_route("solo", w0.device.type, reason):
                return solo_lbfgs.minimize_solo(self, batch, w0, objective)
        if full_ls:
            return minimize_lbfgs(vg, w0, cfg)
        return minimize_lbfgs(None, w0, cfg, oracle=objective.directional_oracle(batch))

    def variances(self, batch, w: torch.Tensor) -> torch.Tensor | None:
        """Coefficient variances (reference computeVariances:82-96):
        SIMPLE → 1/max(diag(H), 1e-12); FULL → diag(H⁻¹) by a Cholesky
        factor of H + 1e-12·I."""
        vc = self.config.variance_computation
        if vc == VarianceComputationType.NONE:
            return None
        if vc == VarianceComputationType.SIMPLE:
            d = self.objective.hessian_diagonal(w, batch)
            return 1.0 / torch.clamp(d, min=1e-12)
        h = self.objective.hessian_matrix(w, batch)
        eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
        chol = torch.linalg.cholesky(h + 1e-12 * eye)
        return torch.diagonal(torch.cholesky_solve(eye, chol), dim1=-2, dim2=-1)

    def down_sampler(self):
        """Host-side sampler applied to a DataSet before batching."""
        return build_down_sampler(
            self.config.task.is_classification, self.config.down_sampling_rate
        )
