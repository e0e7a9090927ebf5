"""The device trace of a fit split by the port's own spans.

A :class:`Trace` holds what the split reads of a ``torch.profiler``
trace (µs, one clock): the port's spans, as ``user_annotation`` events in
Chrome's form joined to the port's span records so that each carries the
record's args (the port's ``obs.export.annotate_device_trace``), the CUDA
runtime calls by correlation id, and the device's kernels, copies and
memsets. :func:`from_chrome` reads one from a Chrome trace's events;
``entries/telemetry.py`` builds one from the profiler's event list. The
join of a kernel to a span goes:

- each kernel to the CUDA runtime call that launched it, by correlation
  id;
- the launch's time and thread to the innermost port span covering it
  (nested ranges end before their parents: the covering range that ends
  first);
- each idle gap of the device (the window less the union of device
  intervals) to the innermost port span, on any thread, that covers the
  gap's midpoint.

A kernel whose launch no span covers, or whose launch is not in the
trace, goes to ``outside spans``.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import heapq
from typing import NamedTuple

from port_bench import trace

OUTSIDE = "outside spans"
TOP = 10


class Trace(NamedTuple):
    spans: list  # user_annotation events (Chrome form: name, tid, ts, dur, args)
    launches: dict  # correlation id -> (thread, start) of the runtime call
    kernels: list  # (correlation id, start, duration)
    copies: list  # (start, duration) of each copy and memset


def from_chrome(events) -> Trace:
    spans, launches, kernels, copies = [], {}, [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat is None:
            continue
        if cat == "user_annotation":
            spans.append(e)
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "cuda_runtime":
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat == "kernel":
            kernels.append((corr, ts, dur))
        elif cat in trace.DEVICE_CATS:
            copies.append((ts, dur))
    return Trace(spans, launches, kernels, copies)


@contextlib.contextmanager
def paused_gc():
    """The cyclic collector off while a trace's hundreds of thousands of
    events are built and split (it would walk them all again and again,
    doubling the wall); back as it was after."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _innermost(ranges, times) -> list:
    """For each time in ``times``, the innermost range of ``ranges``
    ((start, end, event) triples) that covers it, or None. Nested ranges
    end before their parents, so among the covering ranges the innermost
    ends first (port_bench/trace.py's rule for host operations)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    open_, h = [], 0
    for i in order:
        t = times[i]
        while h < len(ranges) and ranges[h][0] <= t:
            heapq.heappush(open_, (ranges[h][1], h))
            h += 1
        while open_ and open_[0][0] < t:
            heapq.heappop(open_)
        if open_:
            out[i] = ranges[open_[0][1]][2]
    return out


def _span_ranges(t: Trace) -> dict:
    by_thread: dict = {}
    for e in t.spans:
        a = float(e["ts"])
        by_thread.setdefault(e.get("tid"), []).append((a, a + float(e.get("dur", 0.0)), e))
    return by_thread


def join(t: Trace) -> dict:
    """``{"kernels": [((start, end), its launch (thread, start) or None,
    innermost span event or None)], "gaps": [((start, end), innermost span
    event or None)], "busy": merged device intervals}``."""
    by_thread = _span_ranges(t)
    queries: dict = {}
    out = []
    for corr, ts, dur in t.kernels:
        call = t.launches.get(corr)
        if call is not None and call[0] in by_thread:
            queries.setdefault(call[0], []).append((len(out), call[1]))
        out.append([(ts, ts + dur), call, None])
    for tid, qs in queries.items():
        for (i, _), span in zip(qs, _innermost(by_thread[tid], [s for _, s in qs])):
            out[i][2] = span
    device = [k[0] for k in out] + [(a, a + d) for a, d in t.copies]
    busy = trace.merge(device)
    starts = [a for a, _ in device] + [s for _, s in t.launches.values()] + \
        [r[0] for rs in by_thread.values() for r in rs]
    ends = [b for _, b in device] + [r[1] for rs in by_thread.values() for r in rs]
    edges = [min(starts), *(x for ab in busy for x in ab), max(ends)] if device else []
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    every = [r for rs in by_thread.values() for r in rs]
    covers = _innermost(every, [0.5 * (a + b) for a, b in gaps])
    return {"kernels": [tuple(k) for k in out], "gaps": list(zip(gaps, covers)), "busy": busy}


def _union_s(intervals) -> float:
    return sum(b - a for a, b in trace.merge(intervals)) / 1e6


def by_span(joined: dict) -> dict:
    """{span name: [launches, device-busy s, idle s]}: the kernels whose
    launch that span is the innermost port span of, the union of their
    intervals, and the idle gaps whose midpoint it covers innermost."""
    launched: dict = {}
    for interval, _, span in joined["kernels"]:
        launched.setdefault(span["name"] if span else OUTSIDE, []).append(interval)
    idle: dict = {}
    for (a, b), span in joined["gaps"]:
        name = span["name"] if span else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {name: [len(launched.get(name, ())), _union_s(launched.get(name, ())),
                   idle.get(name, 0.0)] for name in set(launched) | set(idle)}


def top(table: dict, n: int = TOP) -> list:
    """The ``n`` spans with the most launches plus idle seconds, as
    [name, launches, busy s, idle s] rows, largest first."""
    rows = sorted(table.items(), key=lambda kv: (-(kv[1][0] + kv[1][2] * 1e6), kv[0]))
    return [[name, *vals] for name, vals in rows[:n]]


def per_coordinate(t: Trace, joined: dict, span: str = "descent.coordinate") -> dict:
    """{coordinate: {"launches", "busy_s"}}: the kernels launched inside
    each ``span`` range (its ``coordinate`` arg from the join), at any
    depth, and the union of their intervals; the kernels of ranges
    without the arg are left out."""
    ranges: dict = {}
    for e in t.spans:
        cid = (e.get("args") or {}).get("coordinate")
        if e.get("name") == span and cid is not None:
            a = float(e["ts"])
            ranges.setdefault(e.get("tid"), []).append((a, a + float(e.get("dur", 0.0)), cid))
    for rs in ranges.values():
        rs.sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
    launched: dict = {}
    for interval, call, _ in joined["kernels"]:
        if call is None or call[0] not in ranges:
            continue
        rs = ranges[call[0]]
        i = bisect.bisect_right(starts[call[0]], call[1]) - 1
        if i >= 0 and rs[i][1] >= call[1]:
            launched.setdefault(rs[i][2], []).append(interval)
    return {cid: {"launches": len(iv), "busy_s": _union_s(iv)} for cid, iv in launched.items()}
