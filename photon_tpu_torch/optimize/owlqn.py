"""OWL-QN for L1 and elastic-net objectives, batched over lanes.

Counterpart of ``pseudo_gradient`` and ``minimize_owlqn`` in
photon_tpu/optimize/owlqn.py (Andrew & Gao 2007, as Breeze's OWLQN that
the reference runs, OWLQN.scala:70-85): the pseudo-gradient of
F(x) = f(x) + l1·‖x‖₁, the two-loop L-BFGS direction on it with orthant
alignment, and a backtracking line search with orthant projection. The
(s, y) history is built from gradients of the smooth part f; convergence
is judged on F.

Lanes are written out as in optimize/lbfgs.py: state [B, ...], a converged
lane keeps its state, one host check of "any lane active" per iteration
and per line-search trial. An ``x0`` of shape [D] runs as one lane.
"""
from __future__ import annotations

from typing import Callable

import torch

from photon_tpu_torch.optimize.common import (
    ConvergenceReason,
    OptimizeResult,
    OptimizerConfig,
    SmoothMarginOracle,
    convergence_check,
    project_to_box,
    select_lanes,
)
from photon_tpu_torch.optimize.lbfgs import _CURVATURE_EPS, two_loop_direction

Tensor = torch.Tensor


def pseudo_gradient(x: Tensor, g: Tensor, l1_weight) -> Tensor:
    """The minimal-norm subgradient of f(x) + l1·‖x‖₁ (Andrew & Gao); at
    x = 0 it is 0 where |g| ≤ l1."""
    at_zero_neg = g + l1_weight
    at_zero_pos = g - l1_weight
    zero = torch.zeros_like(g)
    zero_case = torch.where(
        at_zero_neg < 0, at_zero_neg, torch.where(at_zero_pos > 0, at_zero_pos, zero)
    )
    return torch.where(x != 0.0, g + l1_weight * torch.sign(x), zero_case)


def _solo(oracle: SmoothMarginOracle) -> SmoothMarginOracle:
    """Wrap a lane-free oracle (x: [D]) as a one-lane batched one."""

    if oracle.value_margins is None:

        def full_bb(x):
            f, g, carry = oracle.full(x[0])
            return f.unsqueeze(0), g.unsqueeze(0), carry

        return SmoothMarginOracle(full=full_bb, value_margins=None, grad_from_margins=None)

    def full(x):
        f, g, z = oracle.full(x[0])
        return f.unsqueeze(0), g.unsqueeze(0), z.unsqueeze(0)

    def value_margins(x):
        f, z = oracle.value_margins(x[0])
        return f.unsqueeze(0), z.unsqueeze(0)

    def grad_from_margins(x, z):
        return oracle.grad_from_margins(x[0], z[0]).unsqueeze(0)

    return SmoothMarginOracle(
        full=full, value_margins=value_margins, grad_from_margins=grad_from_margins
    )


def minimize_owlqn(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]] | None,
    x0: Tensor,
    l1_weight: float,
    config: OptimizerConfig = OptimizerConfig(),
    *,
    oracle: SmoothMarginOracle | None = None,
) -> OptimizeResult:
    """Minimize f(x) + l1_weight·‖x‖₁, with ``value_and_grad`` or
    ``oracle`` evaluating the smooth part f. ``x0`` is [D] or [B, D]. The
    result's ``gradient`` is the pseudo-gradient at the solution.

    With a ``SmoothMarginOracle`` a backtracking trial computes the value
    only (one forward pass) and the accepted point's gradient comes from
    its margins (one backward pass): trials + 1 passes per iteration, where
    black-box trials cost two each."""
    if oracle is not None and value_and_grad is not None:
        raise ValueError("pass value_and_grad=None when oracle is given")
    if oracle is None:
        if value_and_grad is None:
            raise ValueError("need value_and_grad or oracle")

        def _full(x):
            f, g = value_and_grad(x)
            return f, g, ()

        oracle = SmoothMarginOracle(full=_full, value_margins=None, grad_from_margins=None)
    solo = x0.dim() == 1
    if solo:
        oracle = _solo(oracle)
        x0 = x0.unsqueeze(0)

    dtype, dev = x0.dtype, x0.device
    b, d = x0.shape
    m, t = config.num_corrections, config.max_iterations
    lanes = torch.arange(b, device=dev)
    l1 = torch.as_tensor(l1_weight, dtype=dtype, device=dev)
    has_box = config.has_box
    margin_trials = oracle.value_margins is not None

    def eval_smooth(x):
        f, g, carry = oracle.full(x)
        return f.to(dtype), g.to(dtype), carry

    def full_value(f_smooth, x):
        return f_smooth + l1 * x.abs().sum(-1)

    def box(x):
        return project_to_box(x, config.lower_bounds, config.upper_bounds)

    if has_box:
        x0 = box(x0)
    # absolute tolerances from the zero state (Optimizer.scala:181)
    zeros = torch.zeros_like(x0)
    f_zero, g_zero, _ = eval_smooth(zeros)
    loss_abs_tol = torch.abs(f_zero) * config.tolerance
    grad_abs_tol = (
        torch.linalg.vector_norm(pseudo_gradient(zeros, g_zero, l1), dim=-1)
        * config.tolerance
    )
    f_s, g, carry = eval_smooth(x0)
    x, f = x0, full_value(f_s, x0)

    it = torch.zeros(b, dtype=torch.int32, device=dev)
    s_hist = torch.zeros((b, m, d), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((b, m), dtype=dtype, device=dev)
    num_pairs = torch.zeros_like(it)
    pos = torch.zeros_like(it)
    reason = torch.zeros_like(it)
    loss_hist = f.unsqueeze(-1).repeat(1, t + 1)
    gnorm_hist = (
        torch.linalg.vector_norm(pseudo_gradient(x, g, l1), dim=-1)
        .unsqueeze(-1).repeat(1, t + 1)
    )
    n_evals = torch.full_like(it, 2)  # zero-state + initial point
    n_passes = torch.full_like(it, 4)

    for _ in range(t):
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        pg = pseudo_gradient(x, g, l1)
        direction = two_loop_direction(pg, s_hist, y_hist, rho, num_pairs, pos)
        # orthant alignment: drop components that do not descend along pg;
        # fall back to −pg when nothing is left
        direction = torch.where(direction * pg < 0.0, direction, torch.zeros_like(direction))
        degenerate = (direction * direction).sum(-1) == 0.0
        direction = torch.where(degenerate.unsqueeze(-1), -pg, direction)
        # the orthant: sign(x), or sign(−pg) where x is 0
        xi = torch.where(x != 0.0, torch.sign(x), torch.sign(-pg))
        pg_norm = torch.linalg.vector_norm(pg, dim=-1)
        step = torch.where(
            num_pairs == 0,
            torch.clamp(1.0 / torch.clamp(pg_norm, min=1e-12), max=1.0),
            torch.ones_like(pg_norm),
        ).to(dtype)

        # backtracking with orthant projection; Armijo on F along the
        # projected displacement (Andrew & Gao eq. 4)
        ls_iters = torch.zeros_like(it)
        done = ~active
        ls_ok = torch.zeros_like(active)
        x_new, f_new = x, f
        aux = carry if margin_trials else g  # accepted margins, or gradient
        for _ in range(config.ls_max_iterations):
            run = ~done
            if not bool(run.any()):
                break
            x_cand = x + step.unsqueeze(-1) * direction
            x_cand = torch.where(torch.sign(x_cand) == xi, x_cand, torch.zeros_like(x_cand))
            if margin_trials:
                f_s, aux_cand = oracle.value_margins(x_cand)
                f_s = f_s.to(dtype)
            else:
                f_s, aux_cand, _ = eval_smooth(x_cand)
            f_cand = full_value(f_s, x_cand)
            dx = x_cand - x
            ok = (
                (f_cand <= f + config.ls_c1 * (pg * dx).sum(-1))
                & ((dx * dx).sum(-1) > 0.0)
                & run
            )
            x_new, f_new, aux = select_lanes(ok, (x_cand, f_cand, aux_cand), (x_new, f_new, aux))
            ls_iters = torch.where(run, ls_iters + 1, ls_iters)
            step = torch.where(run, step * 0.5, step)
            done = done | ok
            ls_ok = ls_ok | ok

        if not margin_trials:
            g_new, carry_new = aux, carry
            passes = 2 * ls_iters
        elif has_box:
            # the projected point is evaluated in full below
            g_new, carry_new = g, aux
            passes = ls_iters
        else:
            g_new = oracle.grad_from_margins(x_new, aux).to(dtype)
            carry_new = aux
            passes = ls_iters + 1
        if has_box:
            # box projection after every step, like the reference's OWLQN
            x_new = box(x_new)
            f_s, g_new, carry_new = eval_smooth(x_new)
            f_new = full_value(f_s, x_new)
            ls_iters = ls_iters + 1
            passes = passes + 2

        # curvature pair from smooth gradients
        s_vec = x_new - x
        y_vec = g_new - g
        sy = (s_vec * y_vec).sum(-1)
        pair = active & (sy > _CURVATURE_EPS)
        s_hist[lanes, pos] = torch.where(pair.unsqueeze(-1), s_vec, s_hist[lanes, pos])
        y_hist[lanes, pos] = torch.where(pair.unsqueeze(-1), y_vec, y_hist[lanes, pos])
        rho[lanes, pos] = torch.where(
            pair, 1.0 / torch.where(pair, sy, torch.ones_like(sy)), rho[lanes, pos]
        )
        pos = torch.where(pair, (pos + 1) % m, pos)
        num_pairs = torch.where(pair, num_pairs + 1, num_pairs)

        it_new = it + 1
        pg_new_norm = torch.linalg.vector_norm(pseudo_gradient(x_new, g_new, l1), dim=-1)
        reason_new = convergence_check(
            it=it_new, value=f_new, prev_value=f, grad_norm=pg_new_norm,
            loss_abs_tol=loss_abs_tol, grad_abs_tol=grad_abs_tol,
            max_iterations=t, step_failed=~ls_ok,
        )
        slot = it_new.long()
        loss_hist[lanes, slot] = torch.where(active, f_new, loss_hist[lanes, slot])
        gnorm_hist[lanes, slot] = torch.where(active, pg_new_norm, gnorm_hist[lanes, slot])
        n_evals = torch.where(active, n_evals + ls_iters, n_evals)
        n_passes = torch.where(active, n_passes + passes, n_passes)
        x, f, g, carry, it, reason = select_lanes(
            active, (x_new, f_new, g_new, carry_new, it_new, reason_new),
            (x, f, g, carry, it, reason),
        )

    pg_final = pseudo_gradient(x, g, l1)
    idx = torch.arange(t + 1, device=dev)
    upto = idx.unsqueeze(0) <= it.unsqueeze(-1)
    loss_hist = torch.where(upto, loss_hist, f.unsqueeze(-1))
    gnorm_hist = torch.where(
        upto, gnorm_hist, torch.linalg.vector_norm(pg_final, dim=-1).unsqueeze(-1)
    )
    out = OptimizeResult(
        x=x, value=f, gradient=pg_final, iterations=it, reason=reason,
        loss_history=loss_hist, grad_norm_history=gnorm_hist,
        n_evals=n_evals, n_hvp=torch.zeros_like(it), n_feature_passes=n_passes,
    )
    if solo:
        out = OptimizeResult(*(v[0] for v in out))
    return out
