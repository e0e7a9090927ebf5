"""What the readers of the port's own telemetry share: one measurement per
run (``entries/telemetry.py``: more fits with the port's telemetry on, the
last one under ``torch.profiler``), made by the first of them that the
run reads and kept on the run's context, and its device trace split by
the port's spans (``spans.py``); a trace with no device (the CPU) counts
no kernel under any span. Only a ``--trace 1`` run reads per-layer
metrics; a port without the instrumentation gives None and runs nothing.
The spans' breakdown goes to standard error as one line,
``breakdown.by_span: [[span, launches, busy s, idle s], ...]``, and the
measured fits, the join's offset and the measurement's own walls as
another, ``port telemetry: {...}``.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

from port_bench import spans


def measured(ctx) -> dict | None:
    """The run's measurement, made at the first call (None where the
    entry has no cell to step or the port has no sync counter)."""
    if not hasattr(ctx, "port_telemetry"):
        ctx.port_telemetry = _measure(ctx)
    return ctx.port_telemetry


def _measure(ctx) -> dict | None:
    if not hasattr(ctx.cell, "step"):
        return None
    from port_bench.entries import telemetry

    t0 = time.perf_counter()
    m = telemetry.measure(ctx.cell)
    if m is None:
        return None
    t1 = time.perf_counter()
    profiled = m.pop("trace")
    with spans.paused_gc():
        joined = spans.join(profiled)
        m["coordinates"] = spans.per_coordinate(profiled, joined)
        m["by_span"] = spans.by_span(joined)
    m["seconds"].update(measure=t1 - t0, split=time.perf_counter() - t1)
    m["join"]["kernels"] = len(profiled.kernels)
    print("breakdown.by_span: " + json.dumps(spans.top(m["by_span"])), file=sys.stderr)
    print("port telemetry: " + json.dumps({"fits": m["fits"], "join": m["join"],
                                           "seconds": m["seconds"]}), file=sys.stderr)
    return m


def median_fit(ctx, key: str):
    """The median over the measured fits of ``key``, or None."""
    m = measured(ctx)
    if m is None:
        return None
    values = [f[key] for f in m["fits"] if f.get(key) is not None]
    return statistics.median(values) if values else None
