"""The port's own telemetry over a few more fits of a set-up cell.

The readers of ``host_syncs_per_fit``, ``host_wait_pct``,
``coord_launches.*`` and ``coord_busy_s.*`` (``port_bench/telemetry.py``)
call :func:`measure` once a ``--trace 1`` run's window and traced steps
are done. With the port's telemetry on it runs ``PLAIN_FITS`` more steps
(each fit's host syncs per site and the host's wait in them, from the
descent tracker's rows, over the step's wall) and one more under
``torch.profiler``, whose device trace it joins to the port's span
records (the port's ``obs.export.annotate_device_trace``). The last step
before, the harness's traced one (telemetry off), gives its sync counts
too. A port without the sync counter (``obs.host_sync``) gives None and
runs nothing. Like ``game_fit``, this file imports the port.
"""
from __future__ import annotations

import time

from port_bench import spans

PLAIN_FITS = 1
#: sites that an untraced fit does not pass: the profiling mode's
#: per-coordinate barrier and the telemetry-only read of a solve's counters
NOT_IN_A_FIT = ("descent.coordinate_barrier", "optimize.counters")


def supported() -> bool:
    from photon_tpu_torch import obs

    return hasattr(obs, "host_sync") and hasattr(obs.export, "annotate_device_trace")


def fit_syncs(tracker) -> dict:
    """A fit's ``{"syncs": n, "wait_s": s or None}`` over the sites it
    passes untraced, from its sweep rows (which count the whole sweep,
    its barrier included)."""
    syncs, wait, timed = 0, 0.0, False
    for row in tracker:
        if "sweep_seconds" not in row:
            continue
        syncs += sum(n for k, n in row.get("host_syncs", {}).items() if k not in NOT_IN_A_FIT)
        if "sync_wait_s" in row:
            timed = True
            wait += sum(v for k, v in row["sync_wait_s"].items() if k not in NOT_IN_A_FIT)
    return {"syncs": syncs, "wait_s": wait if timed else None}


def _kineto_trace(results) -> spans.Trace:
    """The profiler's event list as a ``spans.Trace`` (µs on the
    profiler's clock, an OS thread id for each host thread): the port's
    ``user_annotation`` ranges, the CUDA runtime calls by correlation id
    and the device's kernels, copies and memsets. Read from the event
    list, which costs a fraction of exporting the JSON trace and parsing
    it."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    ranges, launches, kernels, copies = [], {}, [], []
    for e in results.events():
        if e.device_type() == cpu:
            if e.is_user_annotation():
                ranges.append({"ph": "X", "cat": "user_annotation", "name": e.name(),
                               "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
                               "tid": e.device_resource_id()})
            elif e.name().startswith("cu"):
                launches[e.correlation_id()] = (e.device_resource_id(), e.start_ns() / 1e3)
        elif not e.is_user_annotation():
            name = e.name()
            if name.startswith(("Memcpy", "Memset")):
                copies.append((e.start_ns() / 1e3, e.duration_ns() / 1e3))
            else:
                kernels.append((e.correlation_id(), e.start_ns() / 1e3, e.duration_ns() / 1e3))
    return spans.Trace(ranges, launches, kernels, copies)


def _profiled(step) -> tuple[spans.Trace, dict]:
    """``step()`` under the profiler, recording the CUDA runtime calls and
    the device's work and, of the host's ranges, those of the user scope
    only: the ``record_function`` ranges that are the port's spans, not
    every aten op (which would more than double the step's wall and the
    events to read). Its trace and the walls of the profiled step and of
    reading it."""
    import torch
    from torch._C._autograd import _enable_profiler
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler

    cuda = torch.cuda.is_available()
    prof = profiler.profile(use_kineto=True, use_device="cuda" if cuda else None)
    t0 = time.perf_counter()
    prof._prepare_trace()
    _enable_profiler(prof.config(create_trace_id=False), prof.kineto_activities,
                     {RecordScope.USER_SCOPE})
    prof.profiling_start_time_ns = time.perf_counter_ns()
    try:
        step()
    finally:
        prof.__exit__(None, None, None)  # synchronizes with the card first
    t1 = time.perf_counter()
    with spans.paused_gc():
        profiled = _kineto_trace(prof.kineto_results)
    return profiled, {"profiled_fit": t1 - t0, "events": time.perf_counter() - t1}


def measure(cell, plain_fits: int = PLAIN_FITS) -> dict | None:
    """``{"fits": [{"syncs", "wait_s", "wall_s"}], "trace": the profiled
    fit's ``spans.Trace``, its spans joined to the port's records, "join": {"spans" (the profiled
    fit's span records), "offset_us", "unmatched_events",
    "unmatched_records"}, "seconds": the measurement's walls}``, or None
    for a port without the instrumentation. Every step it runs is one more whole
    fit, which the judge holds to the reference like the window's."""
    if not supported():
        return None
    from photon_tpu_torch import obs

    fits = []
    if getattr(cell, "last", None) is not None:
        fits.append({**fit_syncs(cell.last.tracker), "wall_s": None})
    was_on = obs.enabled()
    obs.enable()
    try:
        for _ in range(plain_fits):
            t0 = time.perf_counter()
            cell.step()
            wall = time.perf_counter() - t0
            fits.append({**fit_syncs(cell.last.tracker), "wall_s": wall})
        tracer = obs.get_tracer()
        n0 = len(tracer.spans())
        profiled, seconds = _profiled(cell.step)
        fits.append({**fit_syncs(cell.last.tracker), "wall_s": None})
        t0 = time.perf_counter()
        records = tracer.spans()[n0:]
        ranges, join = obs.export.annotate_device_trace(profiled.spans, records)
        seconds["annotate"] = time.perf_counter() - t0
    finally:
        if not was_on:
            obs.disable()
    return {"fits": fits, "trace": profiled._replace(spans=ranges),
            "join": {"spans": len(records), "offset_us": join["offset_us"],
                     "unmatched_events": join["unmatched_events"],
                     "unmatched_records": join["unmatched_records"]},
            "seconds": seconds}
