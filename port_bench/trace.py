"""The device trace of a few steps: ``torch.profiler`` with CPU and CUDA
activity, exported as a Chrome trace into ``TMPDIR`` and reduced there.

The device is busy where a kernel, copy or memset runs: the union of those
intervals (chip_smoke.py's ``device_busy_share`` method). The traced
window runs from the first to the last event of the trace. Each idle gap
between device intervals is put down to the host operation that covered
its midpoint, the innermost one (nested host events end before their
parents, so it is the covering event that ends first).
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


def capture(run) -> dict:
    """``run()`` under the profiler; returns the summary of
    :func:`summarize`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events)


def merge(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> dict:
    """Reduce Chrome trace events (µs) to seconds: ``busy_s``, ``window_s``,
    ``kernels`` ({name: [seconds, launches]}), ``kernel_spans`` ({name:
    [(start, end), ...]} in µs), ``device_ops`` and ``idle_gaps`` (the ten
    largest [name, seconds] each)."""
    dev, host, ops, kernels, spans = [], [], {}, {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            name = e.get("name", "?")
            ops[name] = ops.get(name, 0.0) + dur
            if cat == "kernel":
                k = kernels.setdefault(name, [0.0, 0])
                k[0] += dur / 1e6
                k[1] += 1
                spans.setdefault(name, []).append((ts, ts + dur))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?")))
    merged = merge(dev)
    busy = sum(b - a for a, b in merged)
    every = [(a, b) for a, b in dev] + [(a, b) for a, b, _ in host]
    start = min((a for a, _ in every), default=0.0)
    end = max((b for _, b in every), default=0.0)
    edges = [start] + [x for ab in merged for x in ab] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    open_, by_name, h = [], {}, 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while h < len(host) and host[h][0] <= mid:
            heapq.heappush(open_, (host[h][1], host[h][2]))
            h += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        name = open_[0][1] if open_ else "no host operation"
        by_name[name] = by_name.get(name, 0.0) + (b - a)

    def top(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "busy_s": busy / 1e6,
        "window_s": (end - start) / 1e6,
        "device_events": len(dev),
        "kernels": kernels,
        "kernel_spans": spans,
        "device_ops": top(ops),
        "idle_gaps": top(by_name),
    }
