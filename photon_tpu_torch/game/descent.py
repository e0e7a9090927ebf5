"""Block coordinate descent over GAME coordinates.

Counterpart of ``run_coordinate_descent`` (photon_tpu/game/descent.py:302)
on one device. Each trainable coordinate takes one ``sweep_step`` per
sweep; locked coordinates are scored once and never trained. Every step also gives its health triple
(obs/health.sweep_health); the sweep closes with ONE host copy of all
the triples, stacked, which is also the sweep's device barrier, so the
per-sweep wall is honest and the health check adds no sync. The
divergence policy then acts at the sweep boundary. Per-coordinate walls
are host walls around the step (the L-BFGS loop already syncs once per
iteration). With ``validation_fn`` the states are scored after every
sweep and the best sweep's states are kept as clones. Telemetry, with the
JAX package's names: ``descent.sweeps`` and the sweep and barrier wall
histograms, ``health.checks`` with per-coordinate ``health.loss.<cid>`` /
``health.gnorm.<cid>`` gauges, ``health.divergence``, and flight-ring
records per coordinate step and per sweep (the recovered blackbox of a
killed fit names its last sweep and coordinate).

A streaming coordinate (game/streaming.py) keeps its state, score and
total as CPU tensors and hands over its health as host numbers, so its
steps need no device round-trip here; each sweep row's ``compiles``
counts the one-time costs compile_watch saw in the sweep (a first
dispatch at a chunk shape), 0 from sweep 1 on.

At the end of every sweep the total is summed afresh from the
coordinates' scores, in coordinate order, as a descent that starts from
saved states sums it. So a fit resumed from any sweep's checkpoint
(game/checkpoint.py) takes the same steps, bit for bit, as the fit that
was not interrupted. (The JAX package carries the running total across
sweeps; the two differ by roundoff only.)

Fault points (util/faults.py): ``descent.sweep`` at the start of each
sweep, and ``descent.coordinate`` before each coordinate step, where a
``nan`` clause poisons that coordinate's state on its device.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Mapping, Sequence

import torch

from photon_tpu_torch import obs
from photon_tpu_torch.game.coordinate import Coordinate
from photon_tpu_torch.obs.health import DivergenceError, resolve_policy, sweep_health
from photon_tpu_torch.util import compile_watch, faults

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CoordinateDescentResult:
    states: dict
    total: torch.Tensor  # Σ coordinate scores after the last sweep
    tracker: list
    best_states: dict | None = None  # best-by-validation snapshot
    best_metric: float | None = None


def _barrier(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def clone_state(state):
    """A copy of a coordinate state (tensor, list or tuple of tensors)
    that no later in-place update can reach. A streaming coordinate's
    state is CPU tensors and is copied on the host."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    return type(state)(clone_state(s) for s in state)


def _poison_state_nan(state):
    """Fault injection only (``descent.coordinate`` → ``nan``): every
    leaf of a coordinate state becomes NaN on its device, the divergence
    the health check must catch at this sweep's barrier."""
    if isinstance(state, torch.Tensor):
        return state * float("nan")
    return type(state)(_poison_state_nan(s) for s in state)


def _sum_scores(scores: Mapping[str, torch.Tensor]) -> torch.Tensor:
    total = None
    for s in scores.values():
        total = s if total is None else total + s
    return total


def _read_health(health_dev: Mapping[str, dict], total: torch.Tensor) -> dict:
    """Host health rows from the coordinates' device triples, in ONE
    device-to-host copy of them stacked: the copy waits for every step
    of the sweep, so it is the sweep's barrier as well. A streaming
    coordinate's triple is already on the host and passes through."""
    on_device = [cid for cid, h in health_dev.items() if isinstance(h["loss"], torch.Tensor)]
    if not on_device:
        _barrier(total)
        return {cid: dict(h) for cid, h in health_dev.items()}
    flat = [
        health_dev[cid][k].to(torch.float64)
        for cid in on_device
        for k in ("loss", "gnorm", "finite")
    ]
    vals = torch.stack(flat).cpu().tolist()
    read = {
        cid: {
            "loss": vals[3 * i],
            "gnorm": vals[3 * i + 1],
            "finite": bool(vals[3 * i + 2]),
        }
        for i, cid in enumerate(on_device)
    }
    return {cid: read.get(cid) or dict(h) for cid, h in health_dev.items()}


def _record_health_metrics(health: Mapping[str, dict]) -> None:
    """Mirror the sweep's host health rows into ``health.*`` telemetry
    (no-ops while obs is disabled)."""
    obs.counter("health.checks")
    for cid, h in health.items():
        obs.gauge(f"health.loss.{cid}", h["loss"])
        obs.gauge(f"health.gnorm.{cid}", h["gnorm"])
        obs.histogram("health.gnorm", h["gnorm"])


def run_coordinate_descent(
    coordinates: Mapping[str, Coordinate],
    update_sequence: Sequence[str],
    num_iterations: int,
    *,
    initial_states: Mapping[str, object] | None = None,
    locked_coordinates: frozenset[str] = frozenset(),
    validation_fn: Callable[[Mapping[str, object]], float] | None = None,
    larger_is_better: bool = True,
    start_iteration: int = 0,
    initial_best: tuple[dict, float] | None = None,
    sweep_callback: Callable | None = None,
    sweep_hook: Callable[[int, dict], None] | None = None,
    on_divergence: str | None = None,
) -> CoordinateDescentResult:
    """``validation_fn(states) -> metric`` runs after each sweep on the
    live states (it must not keep them); the best sweep's states are
    cloned into ``best_states``. ``start_iteration``/``initial_best``
    resume a descent from a saved sweep. ``sweep_hook(iteration, row)``
    fires with each sweep's tracker row as it is appended (the estimator
    emits ``sweep_complete`` events through it).

    ``sweep_callback(iteration, states, best_states, best_metric)`` fires
    after every sweep that passed its health check (the checkpointer's
    hook). It gets the LIVE states: what it keeps it must copy before it
    returns, as the checkpointer does when it copies them to the host.

    ``on_divergence`` (None reads ``PHOTON_ON_DIVERGENCE``) is what a
    non-finite sweep does: ``"raise"`` a DivergenceError, ``"warn"``, or
    ``"halt_coordinate"`` (fresh state for the offender, frozen for the
    rest of this descent, the total summed afresh). Each sweep's tracker
    row carries the host health rows as ``health``."""
    on_divergence = resolve_policy(on_divergence)
    unknown = [c for c in update_sequence if c not in coordinates]
    if unknown:
        raise ValueError(f"update sequence references unknown coordinates {unknown}")
    for c in locked_coordinates:
        if c not in coordinates:
            raise ValueError(f"locked coordinate {c} not present")
    states = {
        cid: (
            initial_states[cid]
            if initial_states is not None and cid in initial_states
            else coord.initial_state()
        )
        for cid, coord in coordinates.items()
    }
    # initial scores: locked coordinates contribute through these forever
    scores = {cid: coordinates[cid].score(states[cid]) for cid in coordinates}
    total = _sum_scores(scores)

    tracker: list = []
    best_states, best_metric = initial_best or (None, None)
    trainable = [c for c in update_sequence if c not in locked_coordinates]
    halted: set[str] = set()
    for it in range(start_iteration, num_iterations):
        # fault injection (a no-op without a plan): crash or fail mid-fit
        faults.fault_point("descent.sweep")
        t_sweep = time.perf_counter()
        compiles0 = compile_watch.snapshot()["backend_compiles"]
        health_dev: dict[str, dict] = {}
        for cid in trainable:
            if cid in halted:
                continue
            clause = faults.fault_point("descent.coordinate")
            obs.flight.record("coordinate", iteration=it, coordinate=cid)
            if clause is not None and clause.kind == "nan":
                states[cid] = _poison_state_nan(states[cid])
            t0 = time.perf_counter()
            states[cid], scores[cid], total, info = coordinates[cid].sweep_step(
                total, scores[cid], states[cid]
            )
            if info is not None:  # a coordinate with no optimizer result has no row
                health_dev[cid] = sweep_health(states[cid], info)
            tracker.append(
                {
                    "iteration": it,
                    "coordinate": cid,
                    "seconds": time.perf_counter() - t0,
                    "info": info,
                }
            )
        # the sweep's total summed afresh (see the module docstring)
        total = _sum_scores(scores)
        t_bar = time.perf_counter()
        health = _read_health(health_dev, total)
        now = time.perf_counter()
        sweep_row = {
            "iteration": it,
            "sweep_seconds": now - t_sweep,
            "barrier_seconds": now - t_bar,
            "compiles": compile_watch.snapshot()["backend_compiles"] - compiles0,
            "health": health,
        }
        tracker.append(sweep_row)
        obs.counter("descent.sweeps")
        obs.histogram("descent.sweep_seconds", sweep_row["sweep_seconds"])
        obs.histogram("descent.barrier_seconds", sweep_row["barrier_seconds"])
        _record_health_metrics(health)
        # flight-ring tap at the barrier: host values the sweep's one copy
        # already fetched (no new sync)
        obs.flight.record("sweep", iteration=it,
                          sweep_seconds=round(sweep_row["sweep_seconds"], 6),
                          barrier_seconds=round(sweep_row["barrier_seconds"], 6), health=health)
        if sweep_hook is not None:
            sweep_hook(it, sweep_row)
        for cid in [c for c, h in health.items() if not h["finite"]]:
            obs.counter("health.divergence")
            obs.flight.record("divergence", coordinate=cid, iteration=it, policy=on_divergence,
                              health_row=health[cid])
            obs.instant("health.divergence", cat="lifecycle", coordinate=cid, iteration=it,
                        policy=on_divergence, **health[cid])
            if on_divergence == "raise":
                raise DivergenceError(cid, it, health[cid])
            if on_divergence == "halt_coordinate":
                logger.warning(
                    "coordinate %s diverged at sweep %d (%s); re-initializing and "
                    "halting it for the rest of this descent", cid, it, health[cid],
                )
                halted.add(cid)
                states[cid] = coordinates[cid].initial_state()
                scores[cid] = coordinates[cid].score(states[cid])
                total = _sum_scores(scores)
            else:
                logger.warning(
                    "coordinate %s diverged at sweep %d (%s); policy 'warn' — "
                    "training continues on non-finite state", cid, it, health[cid],
                )
        if validation_fn is not None:
            t_val = time.perf_counter()
            metric = float(validation_fn(states))
            tracker.append(
                {
                    "iteration": it,
                    "validation": metric,
                    "validation_seconds": time.perf_counter() - t_val,
                }
            )
            if best_metric is None or (
                metric > best_metric if larger_is_better else metric < best_metric
            ):
                best_metric = metric
                best_states = {cid: clone_state(s) for cid, s in states.items()}
        if sweep_callback is not None:
            sweep_callback(it, states, best_states, best_metric)
    return CoordinateDescentResult(
        states=states,
        total=total,
        tracker=tracker,
        best_states=best_states,
        best_metric=best_metric,
    )
