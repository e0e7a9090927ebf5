"""L-BFGS with a margin-space strong-Wolfe line search, batched over lanes.

Counterpart of photon_tpu/optimize/lbfgs.py. The JAX solve is one
``lax.while_loop`` that ``vmap`` batches over random-effect entities
(game/coordinate.py:922-932); ``torch.func.vmap`` cannot batch a loop
whose trip count depends on the data, so the lane axis is written out:
state is [B, ...], a converged lane keeps its state through
``torch.where``, and the loop syncs with the host once per iteration on
"any lane active". A solo solve (x0 of shape [D]) runs as one lane.

With a DirectionalOracle every iteration costs exactly two feature passes
(the direction's margins and the accepted point's gradient), whatever the
number of line-search trials.

Box bounds in the config make it L-BFGS-B as the reference runs it: the
iterate is projected into the box after every step and evaluated there in
full (the margin-space trials stay, the accepted gradient is not computed
only to be discarded).
"""
from __future__ import annotations

from typing import Callable

import torch

from photon_tpu_torch import obs
from photon_tpu_torch.optimize.common import (
    ConvergenceReason,
    DirectionalOracle,
    OptimizeResult,
    OptimizerConfig,
    convergence_check,
    project_to_box,
    select_lanes,
)
from photon_tpu_torch.optimize.linesearch import wolfe_search_phi

Tensor = torch.Tensor
_CURVATURE_EPS = 1e-10


def two_loop_direction(
    g: Tensor, s_hist: Tensor, y_hist: Tensor, rho: Tensor,
    num_pairs: Tensor, pos: Tensor,
) -> Tensor:
    """Per-lane two-loop recursion: -H·g from the (s, y) history.
    g [B, D]; s_hist/y_hist [B, m, D]; rho [B, m]; num_pairs/pos [B]."""
    b, m, _ = s_hist.shape
    lanes = torch.arange(b, device=g.device)
    n_valid = torch.clamp(num_pairs, max=m)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)

    q = g
    alphas = []
    for j in range(m):
        idx = (pos - 1 - j) % m
        valid = j < n_valid
        alpha = torch.where(
            valid, rho[lanes, idx] * (s_hist[lanes, idx] * q).sum(-1), zero
        )
        q = q - alpha.unsqueeze(-1) * y_hist[lanes, idx]
        alphas.append(alpha)

    newest = (pos - 1) % m
    s_n, y_n = s_hist[lanes, newest], y_hist[lanes, newest]
    sy = (s_n * y_n).sum(-1)
    yy = (y_n * y_n).sum(-1)
    gamma = torch.where(
        (n_valid > 0) & (yy > 0),
        sy / torch.where(yy > 0, yy, torch.ones_like(yy)),
        torch.ones_like(yy),
    )
    r = gamma.unsqueeze(-1) * q
    for jj in range(m):
        j = m - 1 - jj
        idx = (pos - 1 - j) % m
        valid = j < n_valid
        beta = torch.where(
            valid, rho[lanes, idx] * (y_hist[lanes, idx] * r).sum(-1), zero
        )
        r = r + s_hist[lanes, idx] * (alphas[j] - beta).unsqueeze(-1)
    return -r


def _solo(oracle: DirectionalOracle) -> DirectionalOracle:
    """Wrap a lane-free oracle (x: [D]) as a one-lane batched oracle."""

    def full(x):
        f, g, carry = oracle.full(x[0])
        return f.unsqueeze(0), g.unsqueeze(0), carry

    if oracle.dir_setup is None:
        return DirectionalOracle(full=full, dir_setup=None)

    def dir_setup(carry, x, d):
        phi, accept = oracle.dir_setup(carry, x[0], d[0])

        def phi_b(alpha):
            f, dphi, aux = phi(alpha[0])
            return f.unsqueeze(0), dphi.unsqueeze(0), aux

        def accept_b(alpha):
            g, c = accept(alpha[0])
            return g.unsqueeze(0), c

        return phi_b, accept_b

    return DirectionalOracle(full=full, dir_setup=dir_setup)


def minimize_lbfgs(
    value_and_grad: Callable | None,
    x0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    *,
    oracle: DirectionalOracle | None = None,
) -> OptimizeResult:
    """Minimize with L-BFGS. ``x0`` is [D] (one problem) or [B, D] (B
    independent lanes, with a batched ``value_and_grad``/``oracle``).

    Without an oracle each line-search trial is a full evaluation through
    ``value_and_grad(x) -> (f, g)`` (two passes per trial); with one,
    trials are O(N) on carried margins. The solve is the span
    ``lbfgs.solve`` (lanes, d), each line search ``lbfgs.linesearch``,
    and each iteration's 'any lane active' read the sync site
    ``lbfgs.iteration``."""
    lanes = 1 if x0.dim() == 1 else x0.shape[0]
    with obs.span("lbfgs.solve", cat="solver", lanes=lanes, d=x0.shape[-1]):
        return _minimize_lbfgs(value_and_grad, x0, config, oracle)


def _minimize_lbfgs(value_and_grad, x0: Tensor, config: OptimizerConfig,
                    oracle: DirectionalOracle | None) -> OptimizeResult:
    if oracle is None:
        if value_and_grad is None:
            raise ValueError("need value_and_grad or oracle")

        def _full(x):
            f, g = value_and_grad(x)
            return f, g, ()

        oracle = DirectionalOracle(full=_full, dir_setup=None)
    elif value_and_grad is not None:
        raise ValueError("pass value_and_grad=None when oracle is given")
    solo = x0.dim() == 1
    if solo:
        oracle = _solo(oracle)
        x0 = x0.unsqueeze(0)

    dtype, dev = x0.dtype, x0.device
    b, d = x0.shape
    m, t = config.num_corrections, config.max_iterations
    lanes = torch.arange(b, device=dev)

    def eval_at(x):
        f, g, carry = oracle.full(x)
        return f.to(dtype), g.to(dtype), carry

    # absolute tolerances from the zero-coefficient state
    f_zero, g_zero, _ = eval_at(torch.zeros_like(x0))
    loss_abs_tol = torch.abs(f_zero) * config.tolerance
    grad_abs_tol = torch.linalg.vector_norm(g_zero, dim=-1) * config.tolerance

    has_box = config.has_box
    x = project_to_box(x0, config.lower_bounds, config.upper_bounds)
    f, g, carry = eval_at(x)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    s_hist = torch.zeros((b, m, d), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((b, m), dtype=dtype, device=dev)
    num_pairs = torch.zeros_like(it)
    pos = torch.zeros_like(it)
    reason = torch.zeros_like(it)
    loss_hist = f.unsqueeze(-1).repeat(1, t + 1)
    gnorm_hist = torch.linalg.vector_norm(g, dim=-1).unsqueeze(-1).repeat(1, t + 1)
    n_evals = torch.full_like(it, 2)  # zero-state + initial point
    n_passes = torch.full_like(it, 4)  # 2 full evals × 2 passes

    for _ in range(t):
        active = reason == ConvergenceReason.NOT_CONVERGED
        with obs.host_sync("lbfgs.iteration"):
            # phl-ok: PHL002 one sync per iteration on 'any lane active': the loop's trip count is the data's
            running = bool(active.any())
        if not running:
            break
        direction = two_loop_direction(g, s_hist, y_hist, rho, num_pairs, pos)
        descent = (direction * g).sum(-1) < 0
        direction = torch.where(descent.unsqueeze(-1), direction, -g)

        gnorm = torch.linalg.vector_norm(g, dim=-1)
        init_step = torch.where(
            num_pairs == 0,
            torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0),
            torch.ones_like(gnorm),
        ).to(dtype)
        dphi0 = (g * direction).sum(-1)

        if oracle.dir_setup is None:

            def phi(alpha, x=x, direction=direction):
                f_t, g_t, _ = eval_at(x + alpha.unsqueeze(-1) * direction)
                return f_t, (g_t * direction).sum(-1), (g_t,)

            with obs.span("lbfgs.linesearch", cat="solver"):
                res = wolfe_search_phi(
                    phi, f, dphi0, (g,), initial_step=init_step, active=active,
                    c1=config.ls_c1, c2=config.ls_c2,
                    max_iterations=config.ls_max_iterations,
                )
            x_new = x + res.step.unsqueeze(-1) * direction
            f_new, g_new = res.value, res.aux[0]
            carry_new = carry
            passes = 2 * res.num_evals
        else:
            phi, accept = oracle.dir_setup(carry, x, direction)
            with obs.span("lbfgs.linesearch", cat="solver"):
                res = wolfe_search_phi(
                    phi, f, dphi0, (), initial_step=init_step, active=active,
                    c1=config.ls_c1, c2=config.ls_c2,
                    max_iterations=config.ls_max_iterations,
                )
            x_new = x + res.step.unsqueeze(-1) * direction
            f_new = res.value
            if has_box:
                # the projected point is evaluated in full below
                g_new, carry_new = g, carry
                passes = torch.full_like(it, 1)  # direction margins
            else:
                g_new, carry_new = accept(res.step)
                g_new = g_new.to(dtype)
                passes = torch.full_like(it, 2)  # direction margins + gradient
        num_trials = res.num_evals
        if has_box:
            x_new = project_to_box(x_new, config.lower_bounds, config.upper_bounds)
            f_new, g_new, carry_new = eval_at(x_new)
            num_trials = num_trials + 1
            passes = passes + 2
        step_failed = ~res.success

        # curvature pair update
        s_vec = x_new - x
        y_vec = g_new - g
        sy = (s_vec * y_vec).sum(-1)
        ok = active & (sy > _CURVATURE_EPS)
        s_hist[lanes, pos] = torch.where(ok.unsqueeze(-1), s_vec, s_hist[lanes, pos])
        y_hist[lanes, pos] = torch.where(ok.unsqueeze(-1), y_vec, y_hist[lanes, pos])
        rho[lanes, pos] = torch.where(
            ok, 1.0 / torch.where(ok, sy, torch.ones_like(sy)), rho[lanes, pos]
        )
        pos = torch.where(ok, (pos + 1) % m, pos)
        num_pairs = torch.where(ok, num_pairs + 1, num_pairs)

        it_new = it + 1
        gnorm_new = torch.linalg.vector_norm(g_new, dim=-1)
        reason_new = convergence_check(
            it=it_new, value=f_new, prev_value=f, grad_norm=gnorm_new,
            loss_abs_tol=loss_abs_tol, grad_abs_tol=grad_abs_tol,
            max_iterations=t, step_failed=step_failed,
        )
        slot = torch.clamp(it_new, max=t).long()
        loss_hist[lanes, slot] = torch.where(active, f_new, loss_hist[lanes, slot])
        gnorm_hist[lanes, slot] = torch.where(
            active, gnorm_new, gnorm_hist[lanes, slot]
        )
        n_evals = torch.where(active, n_evals + num_trials, n_evals)
        n_passes = torch.where(active, n_passes + passes, n_passes)
        x, f, g, carry = select_lanes(active, (x_new, f_new, g_new, carry_new), (x, f, g, carry))
        it = torch.where(active, it_new, it)
        reason = torch.where(active, reason_new, reason)

    if oracle.dir_setup is not None and not has_box:
        # the carried margins drift with iteration count; one exact
        # re-evaluation at the final point bounds what callers see (the box
        # path re-evaluates every iteration)
        f, g, _ = eval_at(x)
        n_evals = n_evals + 1
        n_passes = n_passes + 2

    idx = torch.arange(t + 1, device=dev)
    before = idx.unsqueeze(0) < it.unsqueeze(-1)
    loss_hist = torch.where(before, loss_hist, f.unsqueeze(-1))
    gnorm_hist = torch.where(
        before, gnorm_hist, torch.linalg.vector_norm(g, dim=-1).unsqueeze(-1)
    )
    out = OptimizeResult(
        x=x, value=f, gradient=g, iterations=it, reason=reason,
        loss_history=loss_hist, grad_norm_history=gnorm_hist,
        n_evals=n_evals, n_hvp=torch.zeros_like(n_evals), n_feature_passes=n_passes,
    )
    if solo:
        out = OptimizeResult(*(v[0] for v in out))
    return out
