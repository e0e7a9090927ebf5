"""L-BFGS, lane-batched, in plain PyTorch.

Every problem is a lane: ``x`` is [B, D] and ``fun(x)`` returns the B
values and the [B, D] gradients of the smooth part. A lane that has
stopped keeps its state. The rules are Photon-ML's (Breeze's L-BFGS as
the reference runs it, with its ``Optimizer`` stopping tests):

- the absolute tolerances are ``tol`` times the value and the gradient
  norm at x = 0;
- the direction is the two-loop recursion over the last ``m`` curvature
  pairs, scaled by s·y / y·y of the newest; a pair is kept when s·y > 1e-10;
- the first step of a lane with no pair is min(1, 1/‖g‖), later ones 1;
- a strong-Wolfe line search (c1 = 1e-4, c2 = 0.9) that doubles the step
  while bracketing and zooms by safeguarded quadratic interpolation,
  falling back to the best Armijo point of its budget;
- stop at the iteration cap, then on a failed line search, then when the
  value moved by at most its tolerance, then when the gradient norm is
  under its tolerance.

Nothing here is tuned to a data set; the caller gives the iteration
caps, as the configuration states them.
"""
from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor
PAIR_EPS = 1e-10
C1, C2 = 1e-4, 0.9

# stop reasons (Photon-ML's ConvergenceReason)
RUNNING, MAX_ITERATIONS, VALUE_CONVERGED, GRADIENT_CONVERGED, NOT_IMPROVING = 0, 1, 2, 3, 4


def _rowdot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _keep(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` on the lanes of ``mask``, ``old`` elsewhere."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


class History:
    """The last ``m`` curvature pairs of every lane, newest at ``pos - 1``."""

    def __init__(self, b: int, d: int, m: int, dtype, device):
        self.m = m
        self.s = torch.zeros((b, m, d), dtype=dtype, device=device)
        self.y = torch.zeros_like(self.s)
        self.rho = torch.zeros((b, m), dtype=dtype, device=device)
        self.count = torch.zeros(b, dtype=torch.int64, device=device)
        self.pos = torch.zeros(b, dtype=torch.int64, device=device)
        self.lanes = torch.arange(b, device=device)

    def direction(self, g: Tensor) -> Tensor:
        """−H·g by the two-loop recursion."""
        valid_n = torch.clamp(self.count, max=self.m)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        q, alphas = g, []
        for j in range(self.m):
            k = (self.pos - 1 - j) % self.m
            s, y, rho = self.s[self.lanes, k], self.y[self.lanes, k], self.rho[self.lanes, k]
            a = torch.where(j < valid_n, rho * _rowdot(s, q), zero)
            q = q - a.unsqueeze(-1) * y
            alphas.append(a)
        k = (self.pos - 1) % self.m
        s, y = self.s[self.lanes, k], self.y[self.lanes, k]
        sy, yy = _rowdot(s, y), _rowdot(y, y)
        one = torch.ones_like(yy)
        gamma = torch.where((valid_n > 0) & (yy > 0), sy / torch.where(yy > 0, yy, one), one)
        r = gamma.unsqueeze(-1) * q
        for j in reversed(range(self.m)):
            k = (self.pos - 1 - j) % self.m
            s, y, rho = self.s[self.lanes, k], self.y[self.lanes, k], self.rho[self.lanes, k]
            b = torch.where(j < valid_n, rho * _rowdot(y, r), zero)
            r = r + s * (alphas[j] - b).unsqueeze(-1)
        return -r

    def push(self, s: Tensor, y: Tensor, lanes: Tensor) -> None:
        """Keep (s, y) on ``lanes`` where s·y > PAIR_EPS."""
        sy = _rowdot(s, y)
        ok = lanes & (sy > PAIR_EPS)
        at = (self.lanes, self.pos)
        self.s[at] = _keep(ok, s, self.s[at])
        self.y[at] = _keep(ok, y, self.y[at])
        self.rho[at] = torch.where(ok, 1.0 / torch.where(ok, sy, torch.ones_like(sy)),
                                   self.rho[at])
        self.pos = torch.where(ok, (self.pos + 1) % self.m, self.pos)
        self.count = torch.where(ok, self.count + 1, self.count)


def _stop_reason(it, value, prev, gnorm, value_tol, grad_tol, cap, failed) -> Tensor:
    reason = torch.full_like(it, RUNNING)
    reason = torch.where(gnorm <= grad_tol, GRADIENT_CONVERGED, reason)
    reason = torch.where((value - prev).abs() <= value_tol, VALUE_CONVERGED, reason)
    reason = torch.where(failed, NOT_IMPROVING, reason)
    return torch.where(it >= cap, MAX_ITERATIONS, reason)


def _first_step(count: Tensor, gnorm: Tensor) -> Tensor:
    return torch.where(count == 0, torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0),
                       torch.ones_like(gnorm))


def _interpolate(a_lo, f_lo, df_lo, a_hi, f_hi):
    """The minimum of the quadratic through (a_lo, f_lo, df_lo) and
    (a_hi, f_hi), or the midpoint when it falls outside the middle 80%."""
    width = a_hi - a_lo
    curv = f_hi - f_lo - df_lo * width
    safe = torch.where(curv == 0.0, torch.ones_like(curv), curv)
    quad = a_lo - 0.5 * df_lo * width * width / safe
    lo, hi = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
    room = 0.1 * (hi - lo)
    bad = (curv == 0.0) | (quad < lo + room) | (quad > hi - room) | ~torch.isfinite(quad)
    return torch.where(bad, a_lo + 0.5 * width, quad)


def strong_wolfe(phi: Callable[[Tensor], tuple[Tensor, Tensor]], f0: Tensor, df0: Tensor,
                 step0: Tensor, lanes: Tensor, max_trials: int):
    """Per-lane strong-Wolfe search of ``phi(a) -> (f, f')`` along a
    descent direction. Returns (step, value, found): the Wolfe point, else
    the best Armijo point tried, else step 0 and ``found`` False."""
    z = torch.zeros_like(f0)
    no = torch.zeros_like(lanes)
    done, zoom = ~lanes, no.clone()
    trial = torch.zeros_like(f0, dtype=torch.int64)
    a = step0.clone()
    a_prev, f_prev, df_prev = z, f0, df0
    a_lo, f_lo, df_lo, a_hi, f_hi = z, f0, df0, z, f0
    a_ok, f_ok, found = z, f0, no.clone()
    a_best, f_best, has_best = z, f0, no.clone()
    for _ in range(max_trials):
        live = ~done & (trial < max_trials)
        if not bool(live.any()):
            break
        at = torch.where(zoom, _interpolate(a_lo, f_lo, df_lo, a_hi, f_hi), a)
        f, df = phi(at)
        armijo = f <= f0 + C1 * at * df0
        curv = df.abs() <= -C2 * df0
        better = armijo & (~has_best | (f < f_best))

        # bracketing: the interval is found when the trial fails Armijo or
        # rises, or when the slope turns non-negative
        hi_is_trial = ~armijo | ((trial > 0) & (f >= f_prev))
        reverse = armijo & (df >= 0.0) & ~hi_is_trial
        br_done = armijo & curv & ~hi_is_trial
        to_zoom = (hi_is_trial | reverse) & ~br_done
        # zoom: shrink the interval towards the Wolfe point
        shrink = ~armijo | (f >= f_lo)
        zm_done = ~shrink & curv
        swap = ~shrink & ~zm_done & (df * (a_hi - a_lo) >= 0.0)
        stuck = (a_hi - a_lo).abs() * torch.clamp(df0.abs(), min=1.0) <= 1e-12

        n_a_lo = torch.where(zoom, torch.where(shrink, a_lo, at),
                             torch.where(to_zoom, torch.where(hi_is_trial, a_prev, at), a_lo))
        n_f_lo = torch.where(zoom, torch.where(shrink, f_lo, f),
                             torch.where(to_zoom, torch.where(hi_is_trial, f_prev, f), f_lo))
        n_df_lo = torch.where(zoom, torch.where(shrink, df_lo, df),
                              torch.where(to_zoom, torch.where(hi_is_trial, df_prev, df), df_lo))
        n_a_hi = torch.where(zoom, torch.where(shrink, at, torch.where(swap, a_lo, a_hi)),
                             torch.where(to_zoom, torch.where(hi_is_trial, at, a_prev), a_hi))
        n_f_hi = torch.where(zoom, torch.where(shrink, f, torch.where(swap, f_lo, f_hi)),
                             torch.where(to_zoom, torch.where(hi_is_trial, f, f_prev), f_hi))
        finished = torch.where(zoom, zm_done | stuck, br_done)
        accepted = torch.where(zoom, zm_done, br_done)

        def upd(new, old):
            return torch.where(live, new, old)

        a = upd(torch.where(zoom | to_zoom, at, 2.0 * at), a)
        a_prev, f_prev, df_prev = (upd(torch.where(zoom, a_prev, at), a_prev),
                                   upd(torch.where(zoom, f_prev, f), f_prev),
                                   upd(torch.where(zoom, df_prev, df), df_prev))
        a_lo, f_lo, df_lo = upd(n_a_lo, a_lo), upd(n_f_lo, f_lo), upd(n_df_lo, df_lo)
        a_hi, f_hi = upd(n_a_hi, a_hi), upd(n_f_hi, f_hi)
        a_ok = upd(torch.where(accepted, at, a_ok), a_ok)
        f_ok = upd(torch.where(accepted, f, f_ok), f_ok)
        found = upd(found | accepted, found)
        a_best = upd(torch.where(better, at, a_best), a_best)
        f_best = upd(torch.where(better, f, f_best), f_best)
        has_best = upd(has_best | better, has_best)
        zoom = upd(zoom | to_zoom, zoom)
        done = upd(done | finished, done)
        trial = upd(trial + 1, trial)
    fallback = ~found & has_best
    step = torch.where(found, a_ok, torch.where(fallback, a_best, z))
    value = torch.where(found, f_ok, torch.where(fallback, f_best, f0))
    return step, value, found | fallback


def lbfgs(fun: Callable[[Tensor], tuple[Tensor, Tensor]], x0: Tensor, *, max_iterations: int,
          tolerance: float = 1e-7, m: int = 10, max_trials: int = 25) -> dict:
    """Minimize each lane of ``fun`` from ``x0`` [B, D]. Returns ``x``,
    ``value``, ``iterations``, ``reason`` and ``path`` ([B, max_iterations +
    1]: the value from the start and after each iteration, the last one
    repeated once the lane stops) per lane."""
    b, d = x0.shape
    f_zero, g_zero = fun(torch.zeros_like(x0))
    value_tol = f_zero.abs() * tolerance
    grad_tol = torch.linalg.vector_norm(g_zero, dim=-1) * tolerance
    x = x0
    f, g = fun(x)
    hist = History(b, d, m, x0.dtype, x0.device)
    it = torch.zeros(b, dtype=torch.int64, device=x0.device)
    reason = torch.zeros_like(it)
    path = [f]
    for _ in range(max_iterations):
        lanes = reason == RUNNING
        if not bool(lanes.any()):
            break
        p = hist.direction(g)
        p = _keep(_rowdot(p, g) < 0, p, -g)
        step0 = _first_step(hist.count, torch.linalg.vector_norm(g, dim=-1)).to(x.dtype)

        def phi(a, x=x, p=p):
            fa, ga = fun(x + a.unsqueeze(-1) * p)
            return fa, _rowdot(ga, p)

        step, f_new, ok = strong_wolfe(phi, f, _rowdot(g, p), step0, lanes, max_trials)
        x_new = x + step.unsqueeze(-1) * p
        _, g_new = fun(x_new)
        hist.push(x_new - x, g_new - g, lanes)
        it_new = it + 1
        why = _stop_reason(it_new, f_new, f, torch.linalg.vector_norm(g_new, dim=-1),
                           value_tol, grad_tol, max_iterations, ~ok)
        x, f, g = _keep(lanes, x_new, x), torch.where(lanes, f_new, f), _keep(lanes, g_new, g)
        it = torch.where(lanes, it_new, it)
        reason = torch.where(lanes, why, reason)
        path.append(f)
    path += [f] * (max_iterations + 1 - len(path))
    return {"x": x, "value": f, "iterations": it, "reason": reason,
            "path": torch.stack(path, dim=-1)}

