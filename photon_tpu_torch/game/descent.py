"""Block coordinate descent over GAME coordinates.

Counterpart of ``run_coordinate_descent`` (photon_tpu/game/descent.py:302)
on one device, without checkpoint, health or telemetry hooks. Each
trainable coordinate takes one ``sweep_step`` per sweep; locked
coordinates are scored once and never trained. The sweep closes with one
device barrier, so the per-sweep wall is honest; per-coordinate walls are
host walls around the step (the L-BFGS loop already syncs once per
iteration). With ``validation_fn`` the states are scored after every
sweep and the best sweep's states are kept as clones.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import torch

from photon_tpu_torch.game.coordinate import Coordinate


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
    that no later in-place update can reach."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    return type(state)(clone_state(s) for s in state)


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
    sweep_hook: Callable[[int, dict], None] | None = None,
) -> CoordinateDescentResult:
    """``validation_fn(states) -> metric`` runs after each sweep on the
    live states (it must not keep them); the best sweep's states are
    cloned into ``best_states``. ``start_iteration``/``initial_best``
    resume a descent from a saved sweep. ``sweep_hook(iteration, row)``
    fires with each sweep's tracker row as it is appended (the estimator
    emits ``sweep_complete`` events through it)."""
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
    total = None
    for s in scores.values():
        total = s if total is None else total + s

    tracker: list = []
    best_states, best_metric = initial_best or (None, None)
    trainable = [c for c in update_sequence if c not in locked_coordinates]
    for it in range(start_iteration, num_iterations):
        t_sweep = time.perf_counter()
        for cid in trainable:
            t0 = time.perf_counter()
            states[cid], scores[cid], total, info = coordinates[cid].sweep_step(
                total, scores[cid], states[cid]
            )
            tracker.append(
                {
                    "iteration": it,
                    "coordinate": cid,
                    "seconds": time.perf_counter() - t0,
                    "info": info,
                }
            )
        t_bar = time.perf_counter()
        _barrier(total)
        now = time.perf_counter()
        sweep_row = {
            "iteration": it,
            "sweep_seconds": now - t_sweep,
            "barrier_seconds": now - t_bar,
        }
        tracker.append(sweep_row)
        if sweep_hook is not None:
            sweep_hook(it, sweep_row)
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
    return CoordinateDescentResult(
        states=states,
        total=total,
        tracker=tracker,
        best_states=best_states,
        best_metric=best_metric,
    )
