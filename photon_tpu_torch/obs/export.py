"""Exporters: Chrome trace-event JSON, metrics snapshot, JSONL run manifest,
summary tables.

Counterpart of photon_tpu/obs/export.py; the same span sequence exports
the same events. The Chrome trace format (``traceEvents`` of ``ph: "X"``
complete events, ``ts``/``dur`` in microseconds, instants as ``ph: "i"``,
one metadata event naming the process) opens in Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing``. The JSONL run manifest
is a header line, one line per span and a final metrics line.

``export_artifacts`` writes the set a driver run leaves under
``<output>/obs/``: ``trace.json``, ``metrics.json``, ``manifest.jsonl``,
``memory_report.json``, ``summary.txt`` and, when an SLO is armed or batch
latencies were observed, ``slo_report.json``; after a warmed fit, the
device-time breakdown (``breakdown.json``, obs/fleet.py), whose table the
summary ends with.
"""
from __future__ import annotations

import gzip
import json
import logging
import os
from typing import Any, TextIO

MANIFEST_SCHEMA = 1

logger = logging.getLogger(__name__)


def _resolve(tracer, registry):
    """Default to the process-global pipeline (imported lazily: the
    package's __init__ imports this module)."""
    if tracer is None or registry is None:
        from photon_tpu_torch import obs

        tracer = tracer if tracer is not None else obs.get_tracer()
        registry = registry if registry is not None else obs.get_registry()
    return tracer, registry


def _json_safe(v: Any) -> Any:
    """Coerce span args to JSON-encodable values (tensors, numpy scalars,
    paths): an exporter never throws on an attribute."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if hasattr(v, "tolist"):  # numpy arrays and scalars, host tensors
        try:
            return _json_safe(v.tolist())
        except Exception:
            pass
    try:
        return float(v)
    except Exception:
        return str(v)


#: the device's event categories in a ``torch.profiler`` Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _span_args(rec) -> dict:
    args = {**rec.args, "span_id": rec.span_id, "parent_id": rec.parent_id}
    if rec.trace_id is not None:
        args["trace_id"] = rec.trace_id
    return _json_safe(args)


def join_device_trace(events, records) -> dict:
    """Join the events of a ``torch.profiler`` Chrome trace (µs, the
    profiler's clock) to the tracer's span records (``perf_counter_ns``)
    of the same interval.

    Each ``user_annotation`` event is the ``record_function`` range of a
    recorded span, which carries the span's name only. Events and records
    are grouped by (name, OS thread) and paired in order of start. The
    clocks' offset is the median, over the groups whose counts agree, of
    an event's midpoint less its record's (the range opens just before
    the record's clock read and closes just after). A group whose counts
    differ (records from before or after the profiled interval) is then
    paired in order, each event with the nearest unpaired record on the
    profiler's clock, within 1 ms and 1% of the event's length.

    Returns ``{"pairs": [(event, record), ...], "offset_us": float | None,
    "unmatched_events": int, "unmatched_records": int}``: a record's start
    on the profiler's clock is ``t0_ns / 1e3 + offset_us``."""
    def groups(items, key):
        out: dict = {}
        for x in items:
            out.setdefault(key(x), []).append(x)
        return out

    def mid_us(e):
        return float(e["ts"]) + 0.5 * float(e.get("dur", 0.0))

    anns = groups((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  lambda e: (e.get("name"), e.get("tid")))
    recs = groups((r for r in records if not r.instant), lambda r: (r.name, r.native_tid))
    pairs, uneven = [], []
    for key, evs in anns.items():
        evs.sort(key=lambda e: float(e["ts"]))
        rs = sorted(recs.get(key, ()), key=lambda r: r.t0_ns)
        if len(rs) == len(evs):
            pairs.extend(zip(evs, rs))
        elif rs:
            uneven.append((evs, rs))
    offsets = sorted(mid_us(e) - (r.t0_ns + 0.5 * r.dur_ns) / 1e3 for e, r in pairs)
    offset = offsets[len(offsets) // 2] if offsets else None
    if offset is not None:
        for evs, rs in uneven:
            i = 0
            for e in evs:
                t = mid_us(e) - offset
                best = None
                for j in range(i, len(rs)):
                    gap = abs((rs[j].t0_ns + 0.5 * rs[j].dur_ns) / 1e3 - t)
                    if best is not None and gap >= best[1]:
                        break
                    best = (j, gap)
                if best is not None and best[1] <= 1000.0 + 0.01 * float(e.get("dur", 0.0)):
                    pairs.append((e, rs[best[0]]))
                    i = best[0] + 1
    n_events = sum(len(v) for v in anns.values())
    n_records = sum(len(v) for v in recs.values())
    return {"pairs": pairs, "offset_us": offset, "unmatched_events": n_events - len(pairs),
            "unmatched_records": n_records - len(pairs)}


def annotate_device_trace(events, records) -> tuple[list[dict], dict]:
    """``events`` with each joined ``user_annotation`` given its span
    record's args, ``span_id``, ``parent_id`` and ``trace_id``
    (:func:`join_device_trace`), and that join."""
    join = join_device_trace(events, records)
    by_event = {id(e): r for e, r in join["pairs"]}
    out = [{**e, "args": {**(e.get("args") or {}), **_span_args(by_event[id(e)])}}
           if id(e) in by_event else e for e in events]
    return out, join


def _device_events(tracer, device_trace) -> tuple[list[dict], float | None]:
    """The device's kernels, copies and memsets and the host's CUDA
    runtime calls of ``device_trace``, moved onto the tracer's timeline
    by the offset of :func:`join_device_trace` (returned beside them);
    runtime calls go on the track of the span thread that made them."""
    spans = tracer.spans()
    join = join_device_trace(device_trace, spans)
    if join["offset_us"] is None:
        return [], None
    shift = join["offset_us"] + tracer.epoch_ns / 1e3
    threads = {r.native_tid: r.tid for r in spans}
    out, devices = [], set()
    for e in device_trace:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS + ("cuda_runtime",):
            continue
        ev = {**e, "ts": float(e["ts"]) - shift}
        if cat == "cuda_runtime":
            ev["pid"], ev["tid"] = tracer.pid, threads.get(e.get("tid"), e.get("tid"))
        else:
            devices.add(e.get("pid"))
        out.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"device {pid}"}} for pid in sorted(devices, key=str)]
    return meta + out, join["offset_us"]


def chrome_trace(tracer=None, registry=None, meta: dict | None = None,
                 device_trace=None) -> dict:
    """The run as a Chrome trace-event JSON object. With ``device_trace``
    (the events of a ``torch.profiler`` Chrome trace of part of the run),
    the card's kernels, copies and memsets and the CUDA runtime calls join
    the spans on the tracer's clock (:func:`join_device_trace`); the
    offset found is ``otherData.device_offset_us``."""
    tracer, registry = _resolve(tracer, registry)
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": tracer.pid, "tid": 0,
         "args": {"name": "photon-tpu"}}
    ]
    extra: dict = {}
    if device_trace is not None:
        device_events, extra["device_offset_us"] = _device_events(tracer, device_trace)
        events.extend(device_events)
    for rec in tracer.spans():
        ev = {
            "name": rec.name,
            "cat": rec.cat,
            "pid": tracer.pid,
            "tid": rec.tid,
            "ts": (rec.t0_ns - tracer.epoch_ns) / 1e3,
            "args": _span_args(rec),
        }
        if rec.instant:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant marker
        else:
            ev["ph"] = "X"
            ev["dur"] = rec.dur_ns / 1e3
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": _json_safe(
            {"epoch_wall_s": tracer.epoch_wall_s, "metrics": registry.snapshot(), **extra,
             **(meta or {})}
        ),
    }


def write_chrome_trace(path, tracer=None, registry=None, meta=None, device_trace=None) -> str:
    """:func:`chrome_trace` as a JSON file (gzip-compressed when ``path``
    ends in ``.gz``, which Perfetto opens as it is)."""
    doc = chrome_trace(tracer, registry, meta, device_trace)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(doc, f)
    return str(path)


def write_metrics(path, registry=None, meta: dict | None = None) -> str:
    """The registry snapshot (plus caller metadata) as one JSON document,
    counters under ``metrics.counters``."""
    _, registry = _resolve(None, registry)
    with open(path, "w") as f:
        json.dump(_json_safe({**(meta or {}), "metrics": registry.snapshot()}), f, indent=2,
                  sort_keys=True)
    return str(path)


def write_run_manifest(path, tracer=None, registry=None, meta=None) -> str:
    """JSONL manifest: header, one line per span, trailing metrics line."""
    tracer, registry = _resolve(tracer, registry)

    def _dump(f: TextIO, obj: dict) -> None:
        f.write(json.dumps(_json_safe(obj)) + "\n")

    with open(path, "w") as f:
        _dump(f, {"kind": "header", "schema": MANIFEST_SCHEMA, "pid": tracer.pid,
                  "epoch_wall_s": tracer.epoch_wall_s, **(meta or {})})
        for rec in tracer.spans():
            _dump(f, {
                "kind": "instant" if rec.instant else "span",
                "name": rec.name,
                "cat": rec.cat,
                "t_s": round((rec.t0_ns - tracer.epoch_ns) / 1e9, 6),
                "dur_s": round(rec.dur_ns / 1e9, 6),
                "tid": rec.tid,
                "span_id": rec.span_id,
                "parent_id": rec.parent_id,
                "args": rec.args,
            })
        _dump(f, {"kind": "metrics", **registry.snapshot()})
    return str(path)


def write_memory_report(path, meta: dict | None = None) -> str:
    """The memory ledger (obs/memory.py) as one JSON document: recorded
    warm-up footprints, phase-boundary censuses with the peak, and the
    H2D/D2H transfer bill."""
    from photon_tpu_torch.obs import memory as obs_memory

    with open(path, "w") as f:
        json.dump(_json_safe({**(meta or {}), "memory": obs_memory.get_ledger().report()}), f,
                  indent=2, sort_keys=True)
    return str(path)


def _write_summary(path, tracer, registry) -> str:
    from photon_tpu_torch.obs import fleet as obs_fleet

    with open(path, "w") as f:
        f.write(summary_table(tracer) + "\n")
        hist_block = histogram_summary(registry)
        if hist_block:
            f.write("\n" + hist_block + "\n")
        bd_block = obs_fleet.breakdown_table()
        if bd_block:
            f.write("\n" + bd_block + "\n")
    return str(path)


def export_artifacts(directory, prefix: str = "", tracer=None, registry=None,
                     meta: dict | None = None) -> dict:
    """Write the artifact set under ``directory`` and return ``{"trace",
    "metrics", "manifest", "memory", "summary"[, "breakdown", "slo",
    "trace_exemplars"]}`` paths.
    ``prefix`` namespaces the file names."""
    from photon_tpu_torch.obs import slo as obs_slo

    os.makedirs(directory, exist_ok=True)

    def _path(name: str) -> str:
        return os.path.join(str(directory), prefix + name)

    paths = {
        "trace": write_chrome_trace(_path("trace.json"), tracer, registry, meta),
        "metrics": write_metrics(_path("metrics.json"), registry, meta),
        "manifest": write_run_manifest(_path("manifest.jsonl"), tracer, registry, meta),
        "memory": write_memory_report(_path("memory_report.json"), meta),
    }
    # the device-time breakdown only when a fit published one
    # (obs/fleet.py: census bytes and analytic flops joined with the walls)
    from photon_tpu_torch.obs import fleet as obs_fleet

    bd = obs_fleet.get_breakdown()
    if bd is not None:
        bd_path = _path(obs_fleet.BREAKDOWN_FILENAME)
        with open(bd_path, "w") as f:
            json.dump(_json_safe({**(meta or {}), "breakdown": bd}), f, indent=2, sort_keys=True)
        paths["breakdown"] = bd_path
    # the SLO report only when an SLO is armed or latencies were observed
    _, registry_r = _resolve(None, registry)
    slo_doc = obs_slo.report(registry_r)
    if obs_slo.reportable(slo_doc):
        slo_path = _path("slo_report.json")
        with open(slo_path, "w") as f:
            json.dump(_json_safe({**(meta or {}), "slo": slo_doc}), f, indent=2, sort_keys=True)
        paths["slo"] = slo_path
    # the causal-trace exemplars: the document /trace serves, written only
    # when the trace plane is armed
    from photon_tpu_torch.obs import causal as obs_causal

    if obs_causal.active() is not None:
        trace_path = _path("trace_exemplars.json")
        with open(trace_path, "w") as f:
            json.dump(_json_safe(obs_causal.chrome_trace(meta)), f, indent=2, sort_keys=True)
        paths["trace_exemplars"] = trace_path
    paths["summary"] = _write_summary(_path("summary.txt"), tracer, registry)
    return paths


def export_partial_artifacts(directory, prefix: str = "partial.", tracer=None, registry=None,
                             meta: dict | None = None) -> dict:
    """Best-effort artifacts of a FAILED run: the metrics snapshot, the
    manifest and the summary, each written on its own so that one
    exporter choking on the crash's half-built state cannot take the
    others with it. Returns the paths written."""
    try:
        os.makedirs(directory, exist_ok=True)
    except OSError:
        return {}
    tracer, registry = _resolve(tracer, registry)

    def _path(name: str) -> str:
        return os.path.join(str(directory), prefix + name)

    paths: dict = {}
    for name, writer in (
        ("metrics", lambda: write_metrics(_path("metrics.json"), registry, meta)),
        ("manifest", lambda: write_run_manifest(_path("manifest.jsonl"), tracer, registry, meta)),
        ("summary", lambda: _write_summary(_path("summary.txt"), tracer, registry)),
    ):
        try:
            paths[name] = writer()
        except Exception as e:
            logger.warning("partial %s export failed: %s: %s", name, type(e).__name__, e)
    return paths


def histogram_summary(registry=None) -> str:
    """A table of every histogram with its p50/p90/p99/p99.9 (from the
    sparse log buckets); empty when nothing was observed."""
    from photon_tpu_torch.obs.metrics import SUMMARY_PERCENTILES

    _, registry = _resolve(None, registry)
    hists = registry.snapshot()["histograms"]
    if not hists:
        return ""
    rows = sorted(hists.items())
    width = max(len(name) for name, _ in rows)
    pcols = "".join(f" {'p' + str(p):>10}" for p in SUMMARY_PERCENTILES)
    lines = [f"{'histogram':<{width}} {'count':>7} {'mean':>10}{pcols} {'max':>10}"]
    for name, h in rows:
        # non-finite samples count but carry no sum: the mean averages the
        # finite samples, and min/max are None when no sample was finite
        nonfinite = h.get("nonfinite", 0)
        finite_n = h["count"] - nonfinite
        mean = h["sum"] / finite_n if finite_n else 0.0
        h_max = h["max"] if h["max"] is not None else float("nan")
        pvals = "".join(f" {h.get('p' + str(p)) or 0.0:>10.4g}" for p in SUMMARY_PERCENTILES)
        suffix = f"  ({nonfinite} non-finite)" if nonfinite else ""
        lines.append(f"{name:<{width}} {h['count']:>7} {mean:>10.4g}{pvals} {h_max:>10.4g}{suffix}")
    return "\n".join(lines)


def phase_summary(tracer=None) -> dict:
    """Spans aggregated by name: ``{name: {count, total_s, mean_s, max_s}}``."""
    tracer, _ = _resolve(tracer, None)
    out: dict[str, dict] = {}
    for rec in tracer.spans():
        if rec.instant:
            continue
        agg = out.setdefault(rec.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += rec.dur_ns / 1e9
        agg["max_s"] = max(agg["max_s"], rec.dur_ns / 1e9)
    for agg in out.values():
        agg["total_s"] = round(agg["total_s"], 6)
        agg["max_s"] = round(agg["max_s"], 6)
        agg["mean_s"] = round(agg["total_s"] / agg["count"], 6)
    return out


def summary_table(tracer=None) -> str:
    """A per-phase table, widest total first."""
    phases = phase_summary(tracer)
    if not phases:
        return "(no spans recorded)"
    rows = sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])
    width = max(len(name) for name, _ in rows)
    lines = [f"{'phase':<{width}} {'count':>6} {'total_s':>10} {'mean_s':>10} {'max_s':>10}"]
    for name, agg in rows:
        lines.append(f"{name:<{width}} {agg['count']:>6} {agg['total_s']:>10.4f} "
                     f"{agg['mean_s']:>10.4f} {agg['max_s']:>10.4f}")
    return "\n".join(lines)
