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

Work counters, with JAX's names and meanings: each sweep row carries
``dispatches`` (the coordinate-level launch sites of ``obs.record_dispatch``
in the sweep: one per coordinate step, one per streamed chunk, one per
injected NaN; not CUDA kernels), ``compiles`` and ``compile_seconds``
(compile_watch's one-time costs) and ``granularity``. Each coordinate
row and each sweep row (the sweep's coordinates and its barrier) also
carries ``host_syncs``, its blocking reads of the card per sync site of
``obs.host_sync`` (counted whether or not telemetry is on), and, while
telemetry is on, ``sync_wait_s``, the host's wait in them per site. The
descent's own sites: ``descent.barrier`` (the health copy),
``descent.coordinate_barrier`` (the per-coordinate sync of the profiling
mode, or the barrier of a sweep with no device health) and
``descent.validation``. The spans ``descent.initial_score`` and
``descent.coordinate`` (each carrying its own ``dispatches``, the latter
its ``host_syncs`` too), ``descent.sweep`` (carrying those counters) and
``descent.barrier`` enter ``torch.profiler.record_function`` while
telemetry is on, so a profiler trace splits device work by coordinate
(``obs.export.join_device_trace`` gives each range its coordinate).
Each sweep's start and barrier arrival go to the fleet plane's sweep log
(``obs.fleet.record_sweep``, a no-op without a publisher), and each
coordinate's score and step run inside ``parallel.mesh.collective_scope``
so that a mesh's census attributes their collectives to the coordinate.

:func:`precompile_coordinates` is the fit's warm-up (JAX's AOT
precompile pass): it runs every program key of the coordinates once
before the first sweep, so that an unwarmed fit's one-time costs
(``compiles`` in sweep 0) move out of the sweeps.
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
from photon_tpu_torch.parallel.mesh import collective_scope
from photon_tpu_torch.util import compile_watch, faults

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CoordinateDescentResult:
    states: dict
    total: torch.Tensor  # Σ coordinate scores after the last sweep
    tracker: list
    best_states: dict | None = None  # best-by-validation snapshot
    best_metric: float | None = None


def precompile_coordinates(
    coordinates: Mapping[str, Coordinate], *, locked: frozenset = frozenset()
) -> dict:
    """Warm every program a fit dispatches, the counterpart of JAX's
    ``precompile_coordinates`` (photon_tpu/game/descent.py:40): each
    coordinate's ``precompile_specs`` lists ``(key, label, warm_fn)``, and
    each ``warm_fn()`` runs its program once (the coordinate's one-time
    costs: the first launch of each kernel and the lazy load of its
    module, the BLAS handles and workspaces, new allocator segments, the
    load of the native kernel library) and marks its key warmed, so the
    fit's first dispatch at that key is not a cold one. Locked
    coordinates get their score program only; a coordinate that raises
    NotImplementedError is skipped with JAX's warning.

    The programs run one after another on the compute stream, and the
    report says ``max_workers`` 1: JAX overlaps XLA compiles on a thread
    pool, but a warm-up here is device work queued on one stream, which a
    pool has nothing to overlap with. The port's programs never donate
    their inputs, so JAX's ``donate`` has no counterpart either. A warm-up
    that fails raises: JAX logs and goes on because its jit path compiles
    lazily, where here it would hide a broken kernel until the fit.

    The warm-up touches no state, score, total, health or tracker row of
    the fit, no work counter (``obs.record_dispatch``) and no fault
    point. The report keeps JAX's keys that mean something here:
    ``n_programs``, ``max_workers``, ``wall_s``, ``sum_program_walls_s``
    and per program its ``wall_s`` and compile_watch's
    ``backend_compile_s`` (a native build it paid); XLA's lowering wall
    and cache counts have no counterpart."""
    specs = []
    for cid, coord in coordinates.items():
        try:
            entries = coord.precompile_specs(include_sweep=cid not in locked)
        except NotImplementedError:
            logger.warning("coordinate %s does not support precompile", cid)
            continue
        specs.extend((cid, f"{cid}:{label}", warm_fn) for _key, label, warm_fn in entries)
    programs = []
    t0 = time.perf_counter()
    for cid, label, warm_fn in specs:
        with compile_watch.watch() as cw, obs.span("precompile.program", cat="compile",
                                                   program=label), collective_scope(cid):
            t1 = time.perf_counter()
            warm_fn()
            wall = time.perf_counter() - t1
        programs.append({"program": label, "wall_s": round(wall, 4),
                         "backend_compile_s": cw["backend_compile_s"]})
    report = {
        "n_programs": len(programs),
        "max_workers": 1,
        "wall_s": round(time.perf_counter() - t0, 4),
        "sum_program_walls_s": round(sum(p["wall_s"] for p in programs), 4),
        "programs": programs,
    }
    logger.info("warmed %d programs in %.2fs", report["n_programs"], report["wall_s"])
    return report


def _barrier(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        with obs.host_sync("descent.coordinate_barrier"):
            # phl-ok: PHL002 the sweep's device barrier (per-coordinate granularity, or no device health to copy)
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
    the health check must catch at this sweep's barrier. One launch site,
    as in JAX."""
    obs.record_dispatch()
    return _poison_leaves(state)


def _poison_leaves(state):
    if isinstance(state, torch.Tensor):
        return state * float("nan")
    return type(state)(_poison_leaves(s) for s in state)


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
    with obs.host_sync("descent.barrier"):
        # phl-ok: PHL002 the sweep's one health copy, which is also its barrier
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
    tracker_granularity: str = "sweep",
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
    row carries the host health rows as ``health``.

    ``tracker_granularity`` says what the per-coordinate rows' ``seconds``
    mean: ``"sweep"`` (default) the host wall around each step, with ONE
    device barrier closing the sweep (``barrier_seconds``); ``"coordinate"``
    closes each coordinate's step with a device sync, so its ``seconds``
    is the step's whole wall on the card, at the cost of a sync per
    coordinate per sweep (the profiling mode; ``barrier_seconds`` is 0)."""
    on_divergence = resolve_policy(on_divergence)
    if tracker_granularity not in ("sweep", "coordinate"):
        raise ValueError(
            f"tracker_granularity must be 'sweep' or 'coordinate', got {tracker_granularity!r}"
        )
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
    with obs.span("descent.initial_score", coordinates=len(coordinates)) as init_span:
        d0 = obs.dispatch_count()
        scores = {}
        for cid in coordinates:
            with collective_scope(cid, "score"):
                scores[cid] = coordinates[cid].score(states[cid])
        total = _sum_scores(scores)
        init_span.set(dispatches=obs.dispatch_count() - d0)

    tracker: list = []
    best_states, best_metric = initial_best or (None, None)
    trainable = [c for c in update_sequence if c not in locked_coordinates]
    per_coordinate = tracker_granularity == "coordinate"
    halted: set[str] = set()
    for it in range(start_iteration, num_iterations):
        # fault injection (a no-op without a plan): crash or fail mid-fit
        faults.fault_point("descent.sweep")
        d0 = obs.dispatch_count()
        s0 = obs.sync_snapshot()
        c0 = compile_watch.snapshot()
        health_dev: dict[str, dict] = {}
        with obs.span("descent.sweep", iteration=it) as sweep_span:
            for cid in trainable:
                if cid in halted:
                    continue
                clause = faults.fault_point("descent.coordinate")
                obs.flight.record("coordinate", iteration=it, coordinate=cid)
                with obs.span("descent.coordinate", iteration=it, coordinate=cid) as coord_span:
                    dc0 = obs.dispatch_count()
                    sc0 = obs.sync_snapshot()
                    if clause is not None and clause.kind == "nan":
                        states[cid] = _poison_state_nan(states[cid])
                    with collective_scope(cid):
                        states[cid], scores[cid], total, info = coordinates[cid].sweep_step(
                            total, scores[cid], states[cid]
                        )
                    # a coordinate with no optimizer result has no row, nor
                    # has a random effect on a mesh (Coordinate.has_health)
                    if info is not None and coordinates[cid].has_health:
                        health_dev[cid] = sweep_health(states[cid], info)
                    if per_coordinate:
                        _barrier(scores[cid])
                    syncs, waits = obs.syncs_since(sc0)
                    coord_span.set(dispatches=obs.dispatch_count() - dc0,
                                   host_syncs=sum(syncs.values()))
                obs.counter("descent.coordinate_steps")
                row = {
                    "iteration": it,
                    "coordinate": cid,
                    "seconds": coord_span.duration_s,
                    "info": info,
                    "host_syncs": syncs,
                }
                if waits:
                    row["sync_wait_s"] = waits
                tracker.append(row)
            # the sweep's total summed afresh (see the module docstring)
            total = _sum_scores(scores)
            barrier_s = 0.0
            if per_coordinate:
                health = _read_health(health_dev, total)
            else:
                with obs.span("descent.barrier", iteration=it) as bar_span:
                    health = _read_health(health_dev, total)
                barrier_s = bar_span.duration_s
            cw = compile_watch.delta(c0)
            dispatches = obs.dispatch_count() - d0
            syncs, waits = obs.syncs_since(s0)
            sweep_span.set(dispatches=dispatches, compiles=cw["backend_compiles"],
                           compile_seconds=cw["backend_compile_s"], barrier_seconds=barrier_s,
                           granularity=tracker_granularity, host_syncs=sum(syncs.values()))
        sweep_row = {
            "iteration": it,
            "sweep_seconds": sweep_span.duration_s,
            "barrier_seconds": barrier_s,
            "dispatches": dispatches,
            # one-time costs in this sweep: 0 from sweep 1 on
            "compiles": cw["backend_compiles"],
            "compile_seconds": cw["backend_compile_s"],
            "granularity": tracker_granularity,
            "health": health,
            "host_syncs": syncs,
        }
        if waits:
            sweep_row["sync_wait_s"] = waits
        tracker.append(sweep_row)
        obs.counter("descent.sweeps")
        obs.histogram("descent.sweep_seconds", sweep_row["sweep_seconds"])
        obs.histogram("descent.barrier_seconds", sweep_row["barrier_seconds"])
        _record_health_metrics(health)
        # flight-ring tap at the barrier: host values the sweep's one copy
        # already fetched (no new sync)
        obs.flight.record("sweep", iteration=it,
                          sweep_seconds=round(sweep_row["sweep_seconds"], 6),
                          barrier_seconds=round(sweep_row["barrier_seconds"], 6),
                          dispatches=dispatches, health=health)
        # fleet tap (obs/fleet.py): this process's sweep start and barrier
        # arrival, appended to its sweep log; host file I/O only, and two
        # reads of a module global when no fleet publisher is armed
        obs.fleet.record_sweep(it, sweep_row["sweep_seconds"], sweep_row["barrier_seconds"])
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
                with collective_scope(cid, "score"):
                    scores[cid] = coordinates[cid].score(states[cid])
                total = _sum_scores(scores)
            else:
                logger.warning(
                    "coordinate %s diverged at sweep %d (%s); policy 'warn' — "
                    "training continues on non-finite state", cid, it, health[cid],
                )
        if validation_fn is not None:
            t_val = time.perf_counter()
            with obs.host_sync("descent.validation"):
                # phl-ok: PHL002 the validation metric, read once per sweep after the barrier
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
