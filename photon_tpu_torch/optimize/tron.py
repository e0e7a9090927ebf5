"""TRON: trust-region Newton with truncated conjugate gradient, batched
over lanes.

Counterpart of photon_tpu/optimize/tron.py (the LIBLINEAR algorithm the
reference runs, TRON.scala:152-339): an outer trust-region loop with the
η/σ radius rules and an inner truncated CG of at most
``max_cg_iterations`` Hessian-vector products. The JAX solve is a
``lax.while_loop`` that ``vmap`` batches over random-effect entities; here
the lane axis is written out as in optimize/lbfgs.py. State is [B, ...];
a converged lane keeps its state, and a lane whose CG has stopped keeps
its CG state and takes no more Hv steps. The outer loop and the CG loop
each check "any lane active" on the host once per step. An ``x0`` of shape
[D] runs as one lane.
"""
from __future__ import annotations

from typing import Callable

import torch

from photon_tpu_torch import obs
from photon_tpu_torch.optimize.common import (
    ConvergenceReason,
    OptimizeResult,
    OptimizerConfig,
    convergence_check,
    project_to_box,
    select_lanes,
)

Tensor = torch.Tensor

# trust-region update constants (TRON.scala:97-98, as in LIBLINEAR)
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _truncated_cg(
    hvp: Callable[[Tensor], Tensor],
    g: Tensor,
    delta: Tensor,
    active: Tensor,
    *,
    max_iterations: int,
    tolerance: float,
) -> tuple[Tensor, Tensor, Tensor]:
    """Per lane, approximately min_d g·d + d·H·d/2 s.t. ‖d‖ ≤ delta
    (TRON.truncatedConjugateGradientMethod). g [B, D], delta/active [B].
    Returns (d, r, n_hvp) with r = −g − H·d; a lane with ``active`` False
    takes no step."""
    one, zero = torch.ones_like(delta), torch.zeros_like(delta)
    cg_tol = tolerance * torch.linalg.vector_norm(g, dim=-1)
    r = -g
    d = torch.zeros_like(g)
    p = r
    rtr = _dot(r, r)
    i = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    done = ~active
    for _ in range(max_iterations):
        run = ~done & (torch.sqrt(rtr) > cg_tol)
        with obs.host_sync("tron.cg_step"):
            # phl-ok: PHL002 one sync per CG step on 'any lane still running'
            running = bool(run.any())
        if not running:
            break
        hp = hvp(p)
        php = _dot(p, hp)
        curved = php > 0
        # non-positive curvature cannot occur for a convex GLM loss; the
        # guard keeps the loop total
        alpha = torch.where(curved, rtr / torch.where(curved, php, one), zero)
        d_new = d + alpha.unsqueeze(-1) * p
        exceeded = (torch.linalg.vector_norm(d_new, dim=-1) > delta) | ~curved

        # back off to the trust-region boundary along p
        std, dd, pp = _dot(d, p), _dot(d, d), _dot(p, p)
        dsq = delta * delta
        rad = torch.sqrt(torch.clamp(std * std + pp * (dsq - dd), min=0.0))
        alpha_b = torch.where(
            std >= 0,
            (dsq - dd) / torch.where(std + rad > 0, std + rad, one),
            (rad - std) / torch.where(pp > 0, pp, one),
        )
        d_next = torch.where(
            exceeded.unsqueeze(-1), d + alpha_b.unsqueeze(-1) * p, d_new
        )
        r_next = r - torch.where(exceeded, alpha_b, alpha).unsqueeze(-1) * hp
        rtr_new = _dot(r_next, r_next)
        beta = rtr_new / torch.where(rtr > 0, rtr, one)
        p_next = torch.where(exceeded.unsqueeze(-1), p, r_next + beta.unsqueeze(-1) * p)

        d, r, p, rtr = select_lanes(run, (d_next, r_next, p_next, rtr_new), (d, r, p, rtr))
        i = torch.where(run, i + 1, i)
        done = done | (run & exceeded)
    return d, r, i


def _solo(value_and_grad, hvp_factory):
    """Wrap lane-free callables (x: [D]) as one-lane batched ones."""

    def vg(x):
        f, g = value_and_grad(x[0])
        return f.unsqueeze(0), g.unsqueeze(0)

    def factory(x):
        op = hvp_factory(x[0])
        return lambda v: op(v[0]).unsqueeze(0)

    return vg, factory


def minimize_tron(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    hvp: Callable[[Tensor, Tensor], Tensor] | None,
    x0: Tensor,
    config: OptimizerConfig | None = None,
    *,
    hvp_factory: Callable[[Tensor], Callable[[Tensor], Tensor]] | None = None,
) -> OptimizeResult:
    """Minimize a twice-differentiable objective with trust-region Newton.
    ``x0`` is [D] (one problem) or [B, D] (B lanes with batched callables).

    ``hvp(x, v)`` returns H(x)·v; ``hvp_factory(x)`` returns an H(x)·v
    closure and is called once per outer iteration, so a GLM's curvature
    pass is paid once per trust-region step, not per CG step. Only with a
    factory is ``n_feature_passes`` known (2 per evaluation, 2 per Hv, 1
    per curvature pass); with a black-box ``hvp`` it is 0. ``config``
    defaults to the reference TRON envelope (15 iterations, tolerance
    1e-5, CG ≤ 20)."""
    if config is None:
        config = OptimizerConfig().tron_defaults()
    factory_provided = hvp_factory is not None
    if hvp_factory is None:
        if hvp is None:
            raise ValueError("need hvp or hvp_factory")

        def hvp_factory(x):
            return lambda v: hvp(x, v)
    elif hvp is not None:
        raise ValueError("pass hvp=None when hvp_factory is given")
    solo = x0.dim() == 1
    if solo:
        value_and_grad, hvp_factory = _solo(value_and_grad, hvp_factory)
        x0 = x0.unsqueeze(0)

    dtype, dev = x0.dtype, x0.device
    b = x0.shape[0]
    t = config.max_iterations
    lanes = torch.arange(b, device=dev)
    has_box = config.has_box
    if has_box:
        x0 = project_to_box(x0, config.lower_bounds, config.upper_bounds)

    def eval_at(x):
        f, g = value_and_grad(x)
        return f.to(dtype), g.to(dtype)

    f_zero, g_zero = eval_at(torch.zeros_like(x0))
    loss_abs_tol = torch.abs(f_zero) * config.tolerance
    grad_abs_tol = torch.linalg.vector_norm(g_zero, dim=-1) * config.tolerance

    x = x0
    f, g = eval_at(x)
    gnorm = torch.linalg.vector_norm(g, dim=-1)
    delta = gnorm
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    reason = torch.zeros_like(it)
    loss_hist = f.unsqueeze(-1).repeat(1, t + 1)
    gnorm_hist = gnorm.unsqueeze(-1).repeat(1, t + 1)
    n_evals = torch.full_like(it, 2)  # zero-state + initial point
    n_hvp = torch.zeros_like(it)
    one = torch.ones_like(f)

    for _ in range(t):
        active = reason == ConvergenceReason.NOT_CONVERGED
        with obs.host_sync("tron.iteration"):
            # phl-ok: PHL002 one sync per iteration on 'any lane active': the loop's trip count is the data's
            running = bool(active.any())
        if not running:
            break
        step, r, cg_iters = _truncated_cg(
            hvp_factory(x), g, delta, active,
            max_iterations=config.max_cg_iterations, tolerance=config.cg_tolerance,
        )
        snorm = torch.linalg.vector_norm(step, dim=-1)
        gs = _dot(g, step)
        prered = -0.5 * (gs - _dot(step, r))
        x_cand = x + step
        if has_box:
            # project after the step (TRON.scala:226-228), evaluate there
            x_cand = project_to_box(x_cand, config.lower_bounds, config.upper_bounds)
        f_new, g_new = eval_at(x_cand)
        actred = f - f_new

        # radius update (TRON.scala:152-251 / LIBLINEAR tron.cpp)
        denom = f_new - f - gs
        alpha = torch.where(
            denom <= 0,
            _SIGMA3 * one,
            torch.clamp(-0.5 * (gs / torch.where(denom == 0, one, denom)), min=_SIGMA1),
        )
        dl = torch.where(it == 0, torch.minimum(delta, snorm), delta)
        dl = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.clamp(alpha, min=_SIGMA1) * snorm, _SIGMA2 * dl),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(_SIGMA1 * dl, torch.minimum(alpha * snorm, _SIGMA2 * dl)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(_SIGMA1 * dl, torch.minimum(alpha * snorm, _SIGMA3 * dl)),
                    torch.maximum(dl, torch.minimum(alpha * snorm, _SIGMA3 * dl)),
                ),
            ),
        )

        accept = actred > _ETA0 * prered
        x_out, f_out, g_out = select_lanes(accept, (x_cand, f_new, g_new), (x, f, g))
        it_new = it + 1
        gnorm_out = torch.linalg.vector_norm(g_out, dim=-1)
        reason_new = convergence_check(
            it=it_new, value=f_out, prev_value=f, grad_norm=gnorm_out,
            loss_abs_tol=loss_abs_tol, grad_abs_tol=grad_abs_tol,
            max_iterations=t,
            # a rejected step with a vanishing radius cannot make progress
            step_failed=(~accept) & (dl <= 1e-12),
        )
        # a rejected step leaves the loss unchanged: it never reports
        # FUNCTION_VALUES_CONVERGED (the reference keeps iterating with a
        # smaller radius)
        reason_new = torch.where(
            (~accept) & (reason_new == ConvergenceReason.FUNCTION_VALUES_CONVERGED),
            torch.zeros_like(reason_new),
            reason_new,
        )

        slot = it_new.long()
        loss_hist[lanes, slot] = torch.where(active, f_out, loss_hist[lanes, slot])
        gnorm_hist[lanes, slot] = torch.where(active, gnorm_out, gnorm_hist[lanes, slot])
        n_evals = torch.where(active, n_evals + 1, n_evals)
        n_hvp = torch.where(active, n_hvp + cg_iters, n_hvp)
        x, f, g, delta, it, reason = select_lanes(
            active, (x_out, f_out, g_out, dl, it_new, reason_new),
            (x, f, g, delta, it, reason),
        )

    idx = torch.arange(t + 1, device=dev)
    upto = idx.unsqueeze(0) <= it.unsqueeze(-1)
    loss_hist = torch.where(upto, loss_hist, f.unsqueeze(-1))
    gnorm_hist = torch.where(
        upto, gnorm_hist, torch.linalg.vector_norm(g, dim=-1).unsqueeze(-1)
    )
    out = OptimizeResult(
        x=x, value=f, gradient=g, iterations=it, reason=reason,
        loss_history=loss_hist, grad_norm_history=gnorm_hist,
        n_evals=n_evals, n_hvp=n_hvp,
        n_feature_passes=(
            2 * n_evals + 2 * n_hvp + it if factory_provided else torch.zeros_like(it)
        ),
    )
    if solo:
        out = OptimizeResult(*(v[0] for v in out))
    return out
