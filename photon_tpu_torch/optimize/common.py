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
    """Optimizer hyperparameters. Defaults are the reference's L-BFGS
    (maxIter 100, tol 1e-7, m 10); ``tron_defaults`` gives TRON's (maxIter
    15, tol 1e-5, CG ≤ 20). ``lower_bounds``/``upper_bounds`` are box
    constraints ([D] arrays or tensors, broadcast over lanes) or None."""

    max_iterations: int = 100
    tolerance: float = 1e-7
    num_corrections: int = 10
    lower_bounds: object = None
    upper_bounds: object = None
    ls_max_iterations: int = 25
    ls_c1: float = 1e-4
    ls_c2: float = 0.9
    max_cg_iterations: int = 20
    cg_tolerance: float = 0.1

    @property
    def has_box(self) -> bool:
        return self.lower_bounds is not None or self.upper_bounds is not None

    def tron_defaults(self) -> "OptimizerConfig":
        return dataclasses.replace(self, max_iterations=15, tolerance=1e-5)


class DirectionalOracle(NamedTuple):
    """``full(x) -> (f, g, carry)``; ``dir_setup(carry, x, d) -> (phi,
    accept)`` with ``phi(alpha) -> (f, dphi, aux)`` and ``accept(alpha) ->
    (g, carry')``. ``dir_setup`` None means black-box trials through
    ``full``."""

    full: object
    dir_setup: object


class SmoothMarginOracle(NamedTuple):
    """Value-only line-search trials (OWL-QN): ``value_margins(x) -> (f,
    z)`` is one forward pass; ``grad_from_margins(x, z) -> g`` one backward
    pass from the accepted trial's margins; ``full(x) -> (f, g, z)``.
    ``value_margins`` None means black-box trials through ``full``."""

    full: object
    value_margins: object
    grad_from_margins: object


class OptimizeResult(NamedTuple):
    """Terminal state + history. ``loss_history[..., i]`` is the state after
    iteration i, padded past ``iterations`` with the final value;
    ``n_evals`` counts objective evaluations (line-search trials),
    ``n_hvp`` Hessian-vector products and ``n_feature_passes`` passes over
    the feature block."""

    x: torch.Tensor
    value: torch.Tensor
    gradient: torch.Tensor
    iterations: torch.Tensor
    reason: torch.Tensor
    loss_history: torch.Tensor
    grad_norm_history: torch.Tensor
    n_evals: torch.Tensor
    n_hvp: torch.Tensor
    n_feature_passes: torch.Tensor


def select_lanes(cond: torch.Tensor, new, old):
    """Per-lane select over tensors (or tuples of them) whose axis 0 is the
    lane axis of ``cond``: the lane-batched loops keep a finished lane's
    state with it."""
    if isinstance(new, tuple):
        return tuple(select_lanes(cond, a, b) for a, b in zip(new, old))
    return torch.where(cond.view(cond.shape + (1,) * (new.dim() - cond.dim())), new, old)


def record_optimize_metrics(result: OptimizeResult) -> None:
    """Feed a single solve's work counters into the telemetry registry
    (``optimize.iterations`` / ``.n_evals`` / ``.n_hvp`` /
    ``.n_feature_passes``, JAX's names): the inner-loop accounting spans
    cannot see. A no-op while telemetry is disabled; enabled, it reads the
    four scalars back in one copy, a sync with the card (the site
    ``optimize.counters``), so call it where the solve has already been
    waited for."""
    from photon_tpu_torch import obs

    if not obs.enabled():
        return
    names = ("iterations", "n_evals", "n_hvp", "n_feature_passes")
    values = torch.stack([getattr(result, n).reshape(()).to(torch.float64) for n in names])
    with obs.host_sync("optimize.counters"):
        # phl-ok: PHL002 telemetry on only: the solve's counters, read back in one copy
        host = values.tolist()
    for name, v in zip(names, host):
        obs.counter(f"optimize.{name}", int(v))


def project_to_box(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """Clamp coefficients into the box (reference
    OptimizationUtils.projectCoefficientsToSubspace, after every step).
    Bounds are cast to the coefficients' dtype and device; [D] bounds
    broadcast over a leading lane axis."""
    if lower is not None:
        # phl-ok: PHL007, PHL002 box bounds (host arrays of the config, d-vectors replicated with the coefficients they bound) placed at each projection: L-BFGS-B and boxed OWL-QN only
        x = torch.maximum(x, torch.as_tensor(lower, dtype=x.dtype, device=x.device))
    if upper is not None:
        # phl-ok: PHL007, PHL002 box bounds (host arrays of the config, d-vectors replicated with the coefficients they bound) placed at each projection: L-BFGS-B and boxed OWL-QN only
        x = torch.minimum(x, torch.as_tensor(upper, dtype=x.dtype, device=x.device))
    return x


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
