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

The solve is built from init / iteration / finalize pieces
(``_owlqn_machinery``, as JAX's of the same name): ``minimize_owlqn`` runs
them in one loop, ``SegmentedOWLQN`` in bounded segments from the host.
Both call the same pieces in the same order, so on one device they give
the same result bit for bit.

``minimize_owlqn``'s solve is the span ``owlqn.solve`` (lanes, d); in an
iteration of either loop the direction is ``owlqn.direction`` and the
line search ``owlqn.linesearch``. The registry counters
``owlqn.iterations`` (one per iteration of the lane batch) and
``owlqn.trials`` (one per line-search trial) are counted whether or not
telemetry is on (``obs.tally``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from photon_tpu_torch import obs
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


class _OWLQNState(NamedTuple):
    """Lane-batched solver state ([B, ...] tensors). ``carry`` holds the
    accepted point's margins with a margin oracle, else ()."""

    it: Tensor
    x: Tensor
    f: Tensor  # the full objective F = f + l1·‖x‖₁
    g: Tensor  # gradient of the smooth part f
    s_hist: Tensor
    y_hist: Tensor
    rho: Tensor
    num_pairs: Tensor
    pos: Tensor
    reason: Tensor
    loss_hist: Tensor
    gnorm_hist: Tensor
    n_evals: Tensor
    n_passes: Tensor
    loss_abs_tol: Tensor
    grad_abs_tol: Tensor
    carry: object


def _any_active(s: _OWLQNState) -> bool:
    """The host check (one scalar sync, the site ``owlqn.iteration``): is
    any lane still running?"""
    with obs.host_sync("owlqn.iteration"):
        # phl-ok: PHL002 the per-iteration 'any lane active' sync of the OWL-QN loop
        return bool((s.reason == ConvergenceReason.NOT_CONVERGED).any())


def _owlqn_machinery(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]] | None,
    l1_weight: float,
    config: OptimizerConfig,
    *,
    oracle: SmoothMarginOracle | None,
    solo: bool,
):
    """The solve's pieces ``(make_init, step, finalize)``: ``make_init(x0)``
    with x0 [B, D] evaluates the zero state (the absolute tolerances) and
    x0; ``step(s)`` is one OWL-QN iteration (a converged lane keeps its
    state); ``finalize(s)`` the ``OptimizeResult``, without the lane axis
    when ``solo``. The oracle sees [B, D] (``solo`` wraps a lane-free
    one)."""
    if oracle is not None and value_and_grad is not None:
        raise ValueError("pass value_and_grad=None when oracle is given")
    if oracle is None:
        if value_and_grad is None:
            raise ValueError("need value_and_grad or oracle")

        def _full(x):
            f, g = value_and_grad(x)
            return f, g, ()

        oracle = SmoothMarginOracle(full=_full, value_margins=None, grad_from_margins=None)
    if solo:
        oracle = _solo(oracle)
    m, t = config.num_corrections, config.max_iterations
    has_box = config.has_box
    margin_trials = oracle.value_margins is not None

    def eval_smooth(x):
        f, g, carry = oracle.full(x)
        return f.to(x.dtype), g.to(x.dtype), carry

    def full_value(f_smooth, x, l1):
        return f_smooth + l1 * x.abs().sum(-1)

    def box(x):
        return project_to_box(x, config.lower_bounds, config.upper_bounds)

    def make_init(x0: Tensor) -> _OWLQNState:
        dtype, dev = x0.dtype, x0.device
        b, d = x0.shape
        l1 = torch.full((), l1_weight, dtype=dtype, device=dev)
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
        f = full_value(f_s, x0, l1)
        it = torch.zeros(b, dtype=torch.int32, device=dev)
        s_hist = torch.zeros((b, m, d), dtype=dtype, device=dev)
        return _OWLQNState(
            it=it, x=x0, f=f, g=g,
            s_hist=s_hist, y_hist=torch.zeros_like(s_hist),
            rho=torch.zeros((b, m), dtype=dtype, device=dev),
            num_pairs=torch.zeros_like(it), pos=torch.zeros_like(it),
            reason=torch.zeros_like(it),
            loss_hist=f.unsqueeze(-1).repeat(1, t + 1),
            gnorm_hist=(
                torch.linalg.vector_norm(pseudo_gradient(x0, g, l1), dim=-1)
                .unsqueeze(-1).repeat(1, t + 1)
            ),
            n_evals=torch.full_like(it, 2),  # zero-state + initial point
            n_passes=torch.full_like(it, 4),
            loss_abs_tol=loss_abs_tol, grad_abs_tol=grad_abs_tol, carry=carry,
        )

    def step(s: _OWLQNState) -> _OWLQNState:
        obs.tally("owlqn.iterations")
        x, f, g, carry = s.x, s.f, s.g, s.carry
        dtype, dev = x.dtype, x.device
        lanes = torch.arange(x.shape[0], device=dev)
        l1 = torch.full((), l1_weight, dtype=dtype, device=dev)
        active = s.reason == ConvergenceReason.NOT_CONVERGED
        s_hist, y_hist, rho, num_pairs, pos = s.s_hist, s.y_hist, s.rho, s.num_pairs, s.pos
        with obs.span("owlqn.direction", cat="solver"):
            pg = pseudo_gradient(x, g, l1)
            direction = two_loop_direction(pg, s_hist, y_hist, rho, num_pairs, pos)
            # orthant alignment: drop components that do not descend along
            # pg; fall back to −pg when nothing is left
            direction = torch.where(
                direction * pg < 0.0, direction, torch.zeros_like(direction)
            )
            degenerate = (direction * direction).sum(-1) == 0.0
            direction = torch.where(degenerate.unsqueeze(-1), -pg, direction)
            # the orthant: sign(x), or sign(−pg) where x is 0
            xi = torch.where(x != 0.0, torch.sign(x), torch.sign(-pg))
            pg_norm = torch.linalg.vector_norm(pg, dim=-1)
            step_len = torch.where(
                num_pairs == 0,
                torch.clamp(1.0 / torch.clamp(pg_norm, min=1e-12), max=1.0),
                torch.ones_like(pg_norm),
            ).to(dtype)

        # backtracking with orthant projection; Armijo on F along the
        # projected displacement (Andrew & Gao eq. 4)
        ls_iters = torch.zeros_like(s.it)
        done = ~active
        ls_ok = torch.zeros_like(active)
        x_new, f_new = x, f
        aux = carry if margin_trials else g  # accepted margins, or gradient
        with obs.span("owlqn.linesearch", cat="solver"):
            for _ in range(config.ls_max_iterations):
                run = ~done
                with obs.host_sync("owlqn.trial"):
                    # phl-ok: PHL002 one sync per line-search trial on 'any lane still searching'
                    searching = bool(run.any())
                if not searching:
                    break
                obs.tally("owlqn.trials")
                x_cand = x + step_len.unsqueeze(-1) * direction
                x_cand = torch.where(torch.sign(x_cand) == xi, x_cand, torch.zeros_like(x_cand))
                if margin_trials:
                    f_s, aux_cand = oracle.value_margins(x_cand)
                    f_s = f_s.to(dtype)
                else:
                    f_s, aux_cand, _ = eval_smooth(x_cand)
                f_cand = full_value(f_s, x_cand, l1)
                dx = x_cand - x
                ok = (
                    (f_cand <= f + config.ls_c1 * (pg * dx).sum(-1))
                    & ((dx * dx).sum(-1) > 0.0)
                    & run
                )
                x_new, f_new, aux = select_lanes(
                    ok, (x_cand, f_cand, aux_cand), (x_new, f_new, aux)
                )
                ls_iters = torch.where(run, ls_iters + 1, ls_iters)
                step_len = torch.where(run, step_len * 0.5, step_len)
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
            f_new = full_value(f_s, x_new, l1)
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

        it_new = s.it + 1
        pg_new_norm = torch.linalg.vector_norm(pseudo_gradient(x_new, g_new, l1), dim=-1)
        reason_new = convergence_check(
            it=it_new, value=f_new, prev_value=f, grad_norm=pg_new_norm,
            loss_abs_tol=s.loss_abs_tol, grad_abs_tol=s.grad_abs_tol,
            max_iterations=t, step_failed=~ls_ok,
        )
        loss_hist, gnorm_hist = s.loss_hist, s.gnorm_hist
        slot = it_new.long()
        loss_hist[lanes, slot] = torch.where(active, f_new, loss_hist[lanes, slot])
        gnorm_hist[lanes, slot] = torch.where(active, pg_new_norm, gnorm_hist[lanes, slot])
        n_evals = torch.where(active, s.n_evals + ls_iters, s.n_evals)
        n_passes = torch.where(active, s.n_passes + passes, s.n_passes)
        x, f, g, carry, it, reason = select_lanes(
            active, (x_new, f_new, g_new, carry_new, it_new, reason_new),
            (x, f, g, carry, s.it, s.reason),
        )
        return s._replace(
            it=it, x=x, f=f, g=g, s_hist=s_hist, y_hist=y_hist, rho=rho,
            num_pairs=num_pairs, pos=pos, reason=reason, loss_hist=loss_hist,
            gnorm_hist=gnorm_hist, n_evals=n_evals, n_passes=n_passes, carry=carry,
        )

    def finalize(s: _OWLQNState) -> OptimizeResult:
        l1 = torch.full((), l1_weight, dtype=s.x.dtype, device=s.x.device)
        pg_final = pseudo_gradient(s.x, s.g, l1)
        idx = torch.arange(t + 1, device=s.x.device)
        upto = idx.unsqueeze(0) <= s.it.unsqueeze(-1)
        loss_hist = torch.where(upto, s.loss_hist, s.f.unsqueeze(-1))
        gnorm_hist = torch.where(
            upto, s.gnorm_hist, torch.linalg.vector_norm(pg_final, dim=-1).unsqueeze(-1)
        )
        out = OptimizeResult(
            x=s.x, value=s.f, gradient=pg_final, iterations=s.it, reason=s.reason,
            loss_history=loss_hist, grad_norm_history=gnorm_hist,
            n_evals=s.n_evals, n_hvp=torch.zeros_like(s.it), n_feature_passes=s.n_passes,
        )
        if solo:
            out = OptimizeResult(*(v[0] for v in out))
        return out

    return make_init, step, finalize


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
    solo = x0.dim() == 1
    make_init, step, finalize = _owlqn_machinery(
        value_and_grad, l1_weight, config, oracle=oracle, solo=solo
    )
    lanes = 1 if solo else x0.shape[0]
    with obs.span("owlqn.solve", cat="solver", lanes=lanes, d=x0.shape[-1]):
        s = make_init(x0.unsqueeze(0) if solo else x0)
        for _ in range(config.max_iterations):
            if not _any_active(s):
                break
            s = step(s)
        return finalize(s)


class SegmentedOWLQN:
    """OWL-QN run in segments of at most ``segment_iters`` iterations, the
    host checking between segments whether any lane still runs (one
    scalar sync per boundary; the iterations inside a segment check as
    ``minimize_owlqn`` does). Counterpart of JAX's ``SegmentedOWLQN``,
    which bounds each device program of a long solve; here every iteration
    is already driven from the host, and the boundaries are the points
    where a caller may stop or checkpoint a solve. It runs the pieces of
    ``minimize_owlqn`` in the same order, so the two agree bit for bit on
    one device.

    ``oracle_factory(data)`` builds the smooth part's oracle from the
    problem data passed to each call (``__call__(x0, data)``), so one
    solver serves many batches; without it ``value_and_grad`` is used.
    ``last_num_segments`` is the last call's segment count."""

    def __init__(
        self,
        value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]] | None,
        l1_weight: float,
        config: OptimizerConfig = OptimizerConfig(),
        *,
        oracle_factory: Callable[[object], SmoothMarginOracle] | None = None,
        segment_iters: int = 16,
    ):
        if segment_iters < 1:
            raise ValueError(f"segment_iters={segment_iters} < 1")
        if oracle_factory is not None and value_and_grad is not None:
            raise ValueError("pass value_and_grad=None when oracle_factory is given")
        self.value_and_grad = value_and_grad
        self.l1_weight = l1_weight
        self.config = config
        self.oracle_factory = oracle_factory
        self.segment_iters = segment_iters
        self.last_num_segments = 0

    def __call__(self, x0: Tensor, data: object = ()) -> OptimizeResult:
        oracle = self.oracle_factory(data) if self.oracle_factory is not None else None
        solo = x0.dim() == 1
        make_init, step, finalize = _owlqn_machinery(
            self.value_and_grad, self.l1_weight, self.config, oracle=oracle, solo=solo
        )
        s = make_init(x0.unsqueeze(0) if solo else x0)
        steps = n_seg = 0
        while steps < self.config.max_iterations and _any_active(s):
            for i in range(min(self.segment_iters, self.config.max_iterations - steps)):
                if i and not _any_active(s):
                    break
                s = step(s)
                steps += 1
            n_seg += 1
        self.last_num_segments = n_seg
        return finalize(s)
