"""Strong-Wolfe line search on a scalar oracle, batched over lanes.

Counterpart of ``wolfe_search_phi`` (photon_tpu/optimize/linesearch.py:98).
The JAX version is one ``lax.while_loop`` that ``vmap`` batches; here the
lane axis is written out. Every state field is a [B] tensor, a lane that
is done keeps its state (``torch.where`` on the active mask), and the loop
stops when no lane is active — one host sync per trial (the sync site
``linesearch.trial``, obs.host_sync).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from photon_tpu_torch import obs
from photon_tpu_torch.optimize.common import select_lanes

Tensor = torch.Tensor
#: bracketing-stage step growth
_EXPANSION = 2.0


class PhiSearchResult(NamedTuple):
    step: Tensor
    value: Tensor
    aux: tuple
    success: Tensor
    num_evals: Tensor


def _interp(a_lo, phi_lo, dphi_lo, a_hi, phi_hi):
    """Safeguarded quadratic interpolation min inside [a_lo, a_hi]."""
    d = a_hi - a_lo
    denom = phi_hi - phi_lo - dphi_lo * d
    quad = a_lo - 0.5 * dphi_lo * d * d / torch.where(
        denom == 0.0, torch.ones_like(denom), denom
    )
    bisect = a_lo + 0.5 * d
    lo = torch.minimum(a_lo, a_hi)
    hi = torch.maximum(a_lo, a_hi)
    margin = 0.1 * (hi - lo)
    bad = (
        (denom == 0.0)
        | (quad < lo + margin)
        | (quad > hi - margin)
        | ~torch.isfinite(quad)
    )
    return torch.where(bad, bisect, quad)


def wolfe_search_phi(
    phi: Callable[[Tensor], tuple[Tensor, Tensor, tuple]],
    f0: Tensor,
    dphi0: Tensor,
    aux0: tuple,
    *,
    initial_step: Tensor,
    active: Tensor | None = None,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_iterations: int = 25,
) -> PhiSearchResult:
    """Strong-Wolfe search per lane. Without a Wolfe point in budget the
    best Armijo point is returned with ``success`` False; without one,
    step 0. Lanes with ``active`` False start done and stay put."""
    dtype = f0.dtype
    zero = torch.zeros_like(f0)
    no = torch.zeros_like(f0, dtype=torch.bool)
    i = torch.zeros_like(f0, dtype=torch.int32)
    stage = torch.zeros_like(i)
    done = no.clone() if active is None else ~active
    alpha = initial_step.to(dtype)
    a_prev, phi_prev, dphi_prev = zero, f0, dphi0
    a_lo, phi_lo, dphi_lo = zero, f0, dphi0
    a_hi, phi_hi = zero, f0
    a_star, phi_star, aux_star, success = zero, f0, aux0, no
    a_best, phi_best, aux_best, has_best = zero, f0, aux0, no

    for _ in range(max_iterations):
        run = ~done & (i < max_iterations)
        with obs.host_sync("linesearch.trial"):
            # phl-ok: PHL002 one sync per line-search trial on 'any lane still searching'
            searching = bool(run.any())
        if not searching:
            break
        in_zoom = stage == 1
        alpha_t = torch.where(
            in_zoom, _interp(a_lo, phi_lo, dphi_lo, a_hi, phi_hi), alpha
        )
        f, dphi, aux = phi(alpha_t)
        f, dphi = f.to(dtype), dphi.to(dtype)
        armijo = f <= f0 + c1 * alpha_t * dphi0
        curv = torch.abs(dphi) <= -c2 * dphi0
        wolfe = armijo & curv

        better = armijo & ((~has_best) | (f < phi_best))
        n_a_best = torch.where(better, alpha_t, a_best)
        n_phi_best = torch.where(better, f, phi_best)
        n_aux_best = select_lanes(better, aux, aux_best)
        n_has_best = has_best | better

        # bracketing-stage transitions
        br_to_zoom_hi = (~armijo) | ((i > 0) & (f >= phi_prev))
        br_to_zoom_rev = armijo & (dphi >= 0.0) & ~br_to_zoom_hi
        br_done = wolfe & ~br_to_zoom_hi
        br_a_lo = torch.where(br_to_zoom_hi, a_prev, alpha_t)
        br_phi_lo = torch.where(br_to_zoom_hi, phi_prev, f)
        br_dphi_lo = torch.where(br_to_zoom_hi, dphi_prev, dphi)
        br_a_hi = torch.where(br_to_zoom_hi, alpha_t, a_prev)
        br_phi_hi = torch.where(br_to_zoom_hi, f, phi_prev)
        enter_zoom = (br_to_zoom_hi | br_to_zoom_rev) & ~br_done

        # zoom-stage transitions
        shrink_hi = (~armijo) | (f >= phi_lo)
        zm_done = (~shrink_hi) & curv
        flip = (~shrink_hi) & ~zm_done & (dphi * (a_hi - a_lo) >= 0.0)
        zm_a_lo = torch.where(shrink_hi, a_lo, alpha_t)
        zm_phi_lo = torch.where(shrink_hi, phi_lo, f)
        zm_dphi_lo = torch.where(shrink_hi, dphi_lo, dphi)
        zm_a_hi = torch.where(shrink_hi, alpha_t, torch.where(flip, a_lo, a_hi))
        zm_phi_hi = torch.where(
            shrink_hi, f, torch.where(flip, phi_lo, phi_hi)
        )
        zm_stuck = torch.abs(a_hi - a_lo) * torch.clamp(
            torch.abs(dphi0), min=1.0
        ) <= 1e-12

        done_now = torch.where(in_zoom, zm_done | zm_stuck, br_done)
        star_now = torch.where(in_zoom, zm_done, br_done)
        next_stage = torch.where(
            in_zoom, stage, torch.where(enter_zoom, 1, 0).to(stage.dtype)
        )
        next_alpha = torch.where(in_zoom | enter_zoom, alpha_t, alpha_t * _EXPANSION)

        def upd(new, old):
            return select_lanes(run, new, old)

        new_a_lo = torch.where(in_zoom, zm_a_lo, torch.where(enter_zoom, br_a_lo, a_lo))
        new_phi_lo = torch.where(
            in_zoom, zm_phi_lo, torch.where(enter_zoom, br_phi_lo, phi_lo)
        )
        new_dphi_lo = torch.where(
            in_zoom, zm_dphi_lo, torch.where(enter_zoom, br_dphi_lo, dphi_lo)
        )
        new_a_hi = torch.where(in_zoom, zm_a_hi, torch.where(enter_zoom, br_a_hi, a_hi))
        new_phi_hi = torch.where(
            in_zoom, zm_phi_hi, torch.where(enter_zoom, br_phi_hi, phi_hi)
        )
        new_a_prev = torch.where(in_zoom, a_prev, alpha_t)
        new_phi_prev = torch.where(in_zoom, phi_prev, f)
        new_dphi_prev = torch.where(in_zoom, dphi_prev, dphi)

        i = upd(i + 1, i)
        stage = upd(next_stage, stage)
        done = upd(done | done_now, done)
        alpha = upd(next_alpha, alpha)
        a_prev, phi_prev, dphi_prev = (
            upd(new_a_prev, a_prev), upd(new_phi_prev, phi_prev),
            upd(new_dphi_prev, dphi_prev),
        )
        a_lo, phi_lo, dphi_lo = (
            upd(new_a_lo, a_lo), upd(new_phi_lo, phi_lo), upd(new_dphi_lo, dphi_lo)
        )
        a_hi, phi_hi = upd(new_a_hi, a_hi), upd(new_phi_hi, phi_hi)
        a_star = upd(torch.where(star_now, alpha_t, a_star), a_star)
        phi_star = upd(torch.where(star_now, f, phi_star), phi_star)
        aux_star = upd(select_lanes(star_now, aux, aux_star), aux_star)
        success = upd(success | star_now, success)
        a_best, phi_best = upd(n_a_best, a_best), upd(n_phi_best, phi_best)
        aux_best = upd(n_aux_best, aux_best)
        has_best = upd(n_has_best, has_best)

    use_best = (~success) & has_best
    step = torch.where(success, a_star, torch.where(use_best, a_best, zero))
    value = torch.where(success, phi_star, torch.where(use_best, phi_best, f0))
    aux = select_lanes(success, aux_star, select_lanes(use_best, aux_best, aux0))
    return PhiSearchResult(
        step=step, value=value, aux=aux, success=success | use_best, num_evals=i
    )
