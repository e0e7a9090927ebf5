"""Optimizer configs, results and convergence accounting.

Counterpart of photon_tpu/optimize/common.py. Results carry a leading lane
axis when the solve is batched (random-effect entities), none otherwise.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch


class ConvergenceReason(enum.IntEnum):
    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """L-BFGS hyperparameters (reference defaults: maxIter 100, tol 1e-7,
    m 10)."""

    max_iterations: int = 100
    tolerance: float = 1e-7
    num_corrections: int = 10
    ls_max_iterations: int = 25
    ls_c1: float = 1e-4
    ls_c2: float = 0.9


class DirectionalOracle(NamedTuple):
    """``full(x) -> (f, g, carry)``; ``dir_setup(carry, x, d) -> (phi,
    accept)`` with ``phi(alpha) -> (f, dphi, aux)`` and ``accept(alpha) ->
    (g, carry')``. ``dir_setup`` None means black-box trials through
    ``full``."""

    full: object
    dir_setup: object


class OptimizeResult(NamedTuple):
    """Terminal state + history. ``loss_history[..., i]`` is the state after
    iteration i, padded past ``iterations`` with the final value;
    ``n_feature_passes`` counts passes over the feature block."""

    x: torch.Tensor
    value: torch.Tensor
    gradient: torch.Tensor
    iterations: torch.Tensor
    reason: torch.Tensor
    loss_history: torch.Tensor
    grad_norm_history: torch.Tensor
    n_evals: torch.Tensor
    n_feature_passes: torch.Tensor


def convergence_check(
    *,
    it: torch.Tensor,
    value: torch.Tensor,
    prev_value: torch.Tensor,
    grad_norm: torch.Tensor,
    loss_abs_tol: torch.Tensor,
    grad_abs_tol: torch.Tensor,
    max_iterations: int,
    step_failed: torch.Tensor,
) -> torch.Tensor:
    """Reference Optimizer.getConvergenceReason, per lane. Order:
    max-iter > not-improving > function-values > gradient."""
    c = ConvergenceReason
    code = lambda r: torch.full_like(it, int(r))  # noqa: E731
    return torch.where(
        it >= max_iterations,
        code(c.MAX_ITERATIONS),
        torch.where(
            step_failed,
            code(c.OBJECTIVE_NOT_IMPROVING),
            torch.where(
                torch.abs(value - prev_value) <= loss_abs_tol,
                code(c.FUNCTION_VALUES_CONVERGED),
                torch.where(
                    grad_norm <= grad_abs_tol,
                    code(c.GRADIENT_CONVERGED),
                    code(c.NOT_CONVERGED),
                ),
            ),
        ),
    )
