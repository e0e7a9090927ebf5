"""Block coordinate descent over GAME coordinates.

Counterpart of ``run_coordinate_descent`` (photon_tpu/game/descent.py:302)
without checkpoint, health or validation hooks. Each coordinate takes one
``sweep_step`` per sweep; the sweep closes with one device barrier, so the
per-sweep wall is honest. Per-coordinate walls are host walls around the
step (the L-BFGS loop already syncs once per iteration).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import torch

from photon_tpu_torch.game.coordinate import Coordinate


@dataclasses.dataclass
class CoordinateDescentResult:
    states: dict
    total: torch.Tensor  # Σ coordinate scores after the last sweep
    tracker: list


def _barrier(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_coordinate_descent(
    coordinates: Mapping[str, Coordinate],
    update_sequence: Sequence[str],
    num_iterations: int,
    *,
    initial_states: Mapping[str, object] | None = None,
) -> CoordinateDescentResult:
    unknown = [c for c in update_sequence if c not in coordinates]
    if unknown:
        raise ValueError(f"update sequence references unknown coordinates {unknown}")
    states = {
        cid: (
            initial_states[cid]
            if initial_states is not None and cid in initial_states
            else coord.initial_state()
        )
        for cid, coord in coordinates.items()
    }
    scores = {cid: coordinates[cid].score(states[cid]) for cid in coordinates}
    total = None
    for s in scores.values():
        total = s if total is None else total + s

    tracker: list = []
    for it in range(num_iterations):
        t_sweep = time.perf_counter()
        for cid in update_sequence:
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
        tracker.append(
            {
                "iteration": it,
                "sweep_seconds": now - t_sweep,
                "barrier_seconds": now - t_bar,
            }
        )
    return CoordinateDescentResult(states=states, total=total, tracker=tracker)
