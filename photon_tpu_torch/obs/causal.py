"""Request-scoped causal tracing: trace IDs, flow links, tail exemplars.

Counterpart of photon_tpu/obs/causal.py, host code copied so the two
packages write the same documents. The SLO plane (obs/slo.py) answers
"are we slow"; this module answers "why was THIS request slow". A
:class:`TraceCtx` is minted per request (``AdmissionQueue.submit``) or
per streamed chunk (the scoring and training producers) and carries one
process-unique **trace ID** through the whole causal chain: admission →
micro-batch fan-in (many requests → one batch) → H2D → dispatch →
read-back → answer. Each stage records a Chrome-trace ``X`` slice with
the walls the stage already measured (no extra clock reads on the hot
path), and the chain is stitched with Chrome **flow events** (``ph:
"s"/"t"/"f"`` sharing ``id=trace_id``) so Perfetto draws the arrows —
across threads, and across the double buffer, where a chunk's read-back
arrow visibly crosses the NEXT chunk's H2D slice.

A context travels ON the item it describes (the admitted request, the
staged chunk), never in thread state: a chunk's trace is minted on the
producer thread, carried through the page-locked slot and the copy
stream's event, and finished at read-back on the consumer thread. Only
"which trace is active here" is thread-local (:meth:`TraceCtx.active`).

Fault-point firings (util/faults.py) and hot-swap flips land as instant
events attached to whatever trace is active on the firing thread, so a
chaos run shows the injected fault INSIDE the victim's causal chain.

Retention is exemplar-based, not keep-everything:

- **head sampling**: every Nth minted trace (``PHOTON_TRACE_SAMPLE_N``,
  default 1) is ring-retained (``PHOTON_TRACE_RING`` traces) — the
  baseline "what does normal look like";
- **exemplars**: every trace that sheds, blows its deadline, errors, or
  takes an injected fault is nominated, PLUS (the SLO plane's
  nomination) any trace finishing while the fast burn window is hot —
  bucketed per ``PHOTON_TRACE_WINDOW_S`` window, keeping only the
  worst-K by end-to-end wall (``PHOTON_TRACE_WORST_K``) under eviction
  pressure, over a bounded number of windows.

The ``/trace`` endpoint (obs/http.py) serves the merged set as
Perfetto-loadable Chrome-trace JSON; :func:`validate_chrome_trace` is
the schema contract the tests and ``chip_smoke.py`` share (flow events
must resolve — every ``id`` has its ``s`` and ``f`` — and every flow
event must bind inside a slice on its own track).

Overhead discipline: the module global ``_BUFFER`` is None when disarmed
— :func:`mint` is then two module-global reads returning a shared null
context whose every method is a no-op: no lock, no record, and never any
device work (no CUDA launch, no sync, no allocation), so arming or
disarming tracing cannot change a run's answers or its launches. Arm via
``PHOTON_TRACE=1`` (:func:`ensure_from_env` — the streaming scorer, the
streaming trainer, the serving engine and the serving driver all call
it) or programmatically via :func:`install`.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

__all__ = [
    "RequestTraceBuffer",
    "TraceCtx",
    "active",
    "chrome_trace",
    "clear",
    "ensure_from_env",
    "group",
    "install",
    "mark",
    "mark_fault",
    "mint",
    "null",
    "current_trace_id",
    "reset_run_state",
    "validate_chrome_trace",
]

_ENV_ARM = "PHOTON_TRACE"
_ENV_SAMPLE_N = "PHOTON_TRACE_SAMPLE_N"
_ENV_RING = "PHOTON_TRACE_RING"
_ENV_WORST_K = "PHOTON_TRACE_WORST_K"
_ENV_WINDOW_S = "PHOTON_TRACE_WINDOW_S"

#: head-sample every Nth minted trace (1 = every trace)
DEFAULT_SAMPLE_N = 1
#: sampled-trace ring capacity
DEFAULT_RING = 64
#: exemplars retained per window (worst-K by end-to-end wall)
DEFAULT_WORST_K = 8
#: exemplar window seconds
DEFAULT_WINDOW_S = 60.0
#: bounded exemplar history (windows retained)
MAX_WINDOWS = 8
#: events one trace may record (beyond this they are counted, not kept)
MAX_EVENTS_PER_TRACE = 256
#: bounded global lifecycle instants (swaps, unattributed faults)
MAX_GLOBAL_INSTANTS = 256

_FLOW_PHASES = ("s", "t", "f")


def _env_pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    v = int(raw)
    if v < 1:
        raise ValueError(f"{name} must be >= 1, got {v}")
    return v


def _env_pos_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    v = float(raw)
    if v <= 0:
        raise ValueError(f"{name} must be > 0, got {v}")
    return v


class _SharedGroup:
    """Batch fan-in: events the whole micro-batch shares (assemble, H2D,
    dispatch, read-back are one wall for N requests). Recorded ONCE here
    and referenced by every member trace; the exporter de-duplicates by
    object identity so the batch slice appears exactly once."""

    __slots__ = ("name", "buffer", "events", "args")

    def __init__(self, name: str, buffer: "RequestTraceBuffer", args: dict):
        self.name = name
        self.buffer = buffer
        self.events: list[dict] = []
        self.args = args

    def event(self, name, t0_s, dur_s, *, cat="serve", **args):
        self.events.append(
            self.buffer.make_event("X", name, cat, t0_s, dur_s, args)
        )
        return self

    def instant(self, name, *, t_s=None, cat="serve", **args):
        self.events.append(
            self.buffer.make_event("i", name, cat, t_s, 0.0, args)
        )
        return self

    def active(self):
        return _ActiveCM(self)


class TraceCtx:
    """One request's (or chunk's) causal record. Methods are post-hoc
    recorders: call sites pass the walls they already measured
    (``time.perf_counter`` floats) instead of re-reading clocks."""

    __slots__ = (
        "trace_id", "name", "kind", "sampled", "events", "shared",
        "outcome", "e2e_s", "_buffer", "_birth_t", "_done",
    )

    def __init__(
        self,
        buffer: "RequestTraceBuffer",
        trace_id: int,
        name: str,
        kind: str,
        sampled: bool,
    ):
        self._buffer = buffer
        self.trace_id = trace_id
        self.name = name
        self.kind = kind
        self.sampled = sampled
        self.events: list[dict] = []
        self.shared: list[_SharedGroup] = []
        self.outcome: str | None = None
        self.e2e_s: float | None = None
        self._birth_t = time.perf_counter()
        self._done = False

    # -- recording -----------------------------------------------------------

    def _append(self, ev: dict) -> None:
        if self._done:
            return
        if len(self.events) >= MAX_EVENTS_PER_TRACE:
            self._buffer.count_dropped_event()
            return
        self.events.append(ev)

    def event(self, name, t0_s, dur_s, *, cat="request", **args) -> "TraceCtx":
        """Record one complete (``ph: "X"``) slice from already-measured
        stamps; ``t0_s``/``dur_s`` are perf_counter seconds."""
        args.setdefault("trace_id", self.trace_id)
        self._append(
            self._buffer.make_event("X", name, cat, t0_s, dur_s, args)
        )
        return self

    def instant(self, name, *, t_s=None, cat="request", **args) -> "TraceCtx":
        args.setdefault("trace_id", self.trace_id)
        self._append(self._buffer.make_event("i", name, cat, t_s, 0.0, args))
        return self

    def flow(self, phase: str, t_s: float) -> "TraceCtx":
        """Record one flow event (``phase`` ∈ s/t/f, ``id=trace_id``).
        Place ``t_s`` INSIDE a slice recorded on this same thread — flow
        events bind to their enclosing slice (the validator enforces
        it)."""
        if phase not in _FLOW_PHASES:
            raise ValueError(f"flow phase must be one of s/t/f, got {phase!r}")
        ev = self._buffer.make_event("f" if phase == "f" else phase,
                                     self.name, "flow", t_s, 0.0, {})
        ev["id"] = self.trace_id
        self._append(ev)
        return self

    def attach(self, grp) -> "TraceCtx":
        """Reference a shared fan-in group (batch-level events)."""
        if isinstance(grp, _SharedGroup) and grp not in self.shared:
            self.shared.append(grp)
        return self

    def active(self):
        """Context manager marking this trace active on the current
        thread, so :func:`mark_fault` can attach injected-fault instants
        to it."""
        return _ActiveCM(self)

    # -- lifecycle -----------------------------------------------------------

    def finish(self, outcome: str, e2e_s: float | None = None) -> None:
        """Close the trace (idempotent — first outcome wins) and hand it
        to the buffer's retention policy."""
        if self._done:
            return
        if e2e_s is None:
            e2e_s = time.perf_counter() - self._birth_t
        self.instant(
            "trace.finish",
            cat="lifecycle",
            outcome=outcome,
            e2e_s=round(float(e2e_s), 6),
        )
        self.outcome = outcome
        self.e2e_s = float(e2e_s)
        self._done = True
        self._buffer.retain(self)


class _ActiveCM:
    __slots__ = ("_target",)

    def __init__(self, target):
        self._target = target

    def __enter__(self):
        _tls_stack().append(self._target)
        return self._target

    def __exit__(self, exc_type, exc, tb):
        stack = _tls_stack()
        if stack and stack[-1] is self._target:
            stack.pop()


class _NullCtx:
    """The shared disarmed context: every method a no-op, ``active()``
    a reusable nullcontext — call sites never branch on armed state."""

    __slots__ = ()
    trace_id = None
    sampled = False

    def event(self, *a, **k):
        return self

    def instant(self, *a, **k):
        return self

    def flow(self, *a, **k):
        return self

    def attach(self, *a, **k):
        return self

    def finish(self, *a, **k):
        return None

    def active(self):
        return _NULL_CM


_NULL = _NullCtx()
_NULL_CM = contextlib.nullcontext()

_TLS = threading.local()


def _tls_stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class RequestTraceBuffer:
    """The armed state: mints trace IDs, stamps events, and applies the
    sampling-ring + worst-K-exemplar retention policy. Thread-safe (the
    producer, engine, and HTTP scrape threads all touch it)."""

    def __init__(
        self,
        *,
        sample_n: int = DEFAULT_SAMPLE_N,
        ring: int = DEFAULT_RING,
        worst_k: int = DEFAULT_WORST_K,
        window_s: float = DEFAULT_WINDOW_S,
    ):
        if sample_n < 1:
            raise ValueError(f"trace sample_n must be >= 1, got {sample_n}")
        if ring < 1:
            raise ValueError(f"trace ring must be >= 1, got {ring}")
        if worst_k < 1:
            raise ValueError(f"trace worst_k must be >= 1, got {worst_k}")
        if window_s <= 0:
            raise ValueError(f"trace window_s must be > 0, got {window_s}")
        self.sample_n = sample_n
        self.ring_cap = ring
        self.worst_k = worst_k
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._minted = 0
        self._finished = 0
        self._dropped = 0
        self._dropped_events = 0
        self._evicted = 0
        self._ring: list[TraceCtx] = []
        #: window index → exemplar traces (worst-K by e2e)
        self._exemplars: dict[int, list[TraceCtx]] = {}
        self._instants: list[dict] = []
        self._thread_names: dict[int, str] = {}

    # -- event stamping ------------------------------------------------------

    def make_event(self, ph, name, cat, t0_s, dur_s, args) -> dict:
        """One internal event record (perf_counter-ns stamps; the export
        converts to epoch-relative µs). ``t0_s`` None = now."""
        tid = threading.get_ident()
        if tid not in self._thread_names:
            # benign race: worst case two threads write the same name
            self._thread_names[tid] = threading.current_thread().name
        t_ns = (
            time.perf_counter_ns()
            if t0_s is None
            else int(float(t0_s) * 1e9)
        )
        return {
            "ph": ph,
            "name": name,
            "cat": cat,
            "t_ns": t_ns,
            "dur_ns": max(0, int(float(dur_s) * 1e9)),
            "tid": tid,
            "args": args,
        }

    def count_dropped_event(self) -> None:
        with self._lock:
            self._dropped_events += 1

    # -- minting -------------------------------------------------------------

    def mint(self, name: str, kind: str = "request") -> TraceCtx:
        with self._lock:
            self._minted += 1
            sampled = (self._minted - 1) % self.sample_n == 0
            trace_id = next(self._ids)
        return TraceCtx(self, trace_id, name, kind, sampled)

    def group(self, name: str, members, **args) -> _SharedGroup:
        grp = _SharedGroup(name, self, args)
        for m in members:
            if m is not None:
                m.attach(grp)
        return grp

    def instant(self, name, *, cat="lifecycle", **args) -> None:
        ev = self.make_event("i", name, cat, None, 0.0, args)
        with self._lock:
            self._instants.append(ev)
            if len(self._instants) > MAX_GLOBAL_INSTANTS:
                del self._instants[0]

    def mark_fault(self, point: str, kind: str) -> None:
        """A fault point fired: attach the instant to the active trace
        (or batch group) on this thread, else record it globally."""
        stack = _tls_stack()
        if stack:
            stack[-1].instant(
                "fault.injected", cat="fault", point=point, kind=kind
            )
        else:
            self.instant(
                "fault.injected", cat="fault", point=point, kind=kind
            )

    # -- retention -----------------------------------------------------------

    def retain(self, ctx: TraceCtx) -> None:
        exemplar = ctx.outcome != "ok"
        if not exemplar:
            # the SLO plane's nomination: a trace finishing while the
            # fast burn window is hot is tail context worth keeping even
            # though it individually met its deadline
            try:
                from photon_tpu_torch.obs import slo as obs_slo

                tracker = obs_slo.active()
                if tracker is not None and tracker.fast_burning():
                    exemplar = True
            except Exception:  # tracing must never fail the request path
                pass
        with self._lock:
            self._finished += 1
            if exemplar:
                self._add_exemplar_locked(ctx)
            elif ctx.sampled:
                self._ring.append(ctx)
                if len(self._ring) > self.ring_cap:
                    del self._ring[0]
            else:
                self._dropped += 1

    def _add_exemplar_locked(self, ctx: TraceCtx) -> None:
        wkey = int(time.perf_counter() // self.window_s)
        wlist = self._exemplars.setdefault(wkey, [])
        wlist.append(ctx)
        if len(wlist) > self.worst_k:
            # worst-K by end-to-end wall: evict the least-bad exemplar
            worst = min(wlist, key=lambda t: t.e2e_s or 0.0)
            wlist.remove(worst)
            self._evicted += 1
        while len(self._exemplars) > MAX_WINDOWS:
            oldest = min(self._exemplars)
            self._evicted += len(self._exemplars.pop(oldest))

    # -- reading -------------------------------------------------------------

    def traces(self) -> list[TraceCtx]:
        """Every retained trace (sampled ring + exemplars), oldest id
        first — a snapshot copy, safe while other threads record."""
        with self._lock:
            out = list(self._ring)
            for wlist in self._exemplars.values():
                out.extend(wlist)
        return sorted(out, key=lambda t: t.trace_id)

    def export_state(self):
        with self._lock:
            ring = list(self._ring)
            exemplars = [t for w in self._exemplars.values() for t in w]
            instants = list(self._instants)
            names = dict(self._thread_names)
            stats = {
                "minted": self._minted,
                "finished": self._finished,
                "retained_sampled": len(ring),
                "retained_exemplars": len(exemplars),
                "windows": len(self._exemplars),
                "dropped": self._dropped,
                "dropped_events": self._dropped_events,
                "evicted_exemplars": self._evicted,
                "sample_n": self.sample_n,
                "worst_k": self.worst_k,
                "window_s": self.window_s,
            }
        traces = sorted(ring + exemplars, key=lambda t: t.trace_id)
        return traces, instants, names, stats

    def reset_run_state(self) -> None:
        """Per-run reset (``obs.reset()``): retained traces and censuses
        dropped, the arming and its knobs kept."""
        with self._lock:
            self._ring.clear()
            self._exemplars.clear()
            self._instants.clear()
            self._minted = 0
            self._finished = 0
            self._dropped = 0
            self._dropped_events = 0
            self._evicted = 0


#: the armed buffer — None is THE disarmed state every hot path checks
_BUFFER: RequestTraceBuffer | None = None


def active() -> RequestTraceBuffer | None:
    return _BUFFER


def install(
    *,
    sample_n: int | None = None,
    ring: int | None = None,
    worst_k: int | None = None,
    window_s: float | None = None,
) -> RequestTraceBuffer:
    """Arm causal tracing (replacing any armed buffer) and return it.
    Unspecified knobs come from the env (loud on bad values)."""
    global _BUFFER
    buf = RequestTraceBuffer(
        sample_n=(
            _env_pos_int(_ENV_SAMPLE_N, DEFAULT_SAMPLE_N)
            if sample_n is None
            else sample_n
        ),
        ring=_env_pos_int(_ENV_RING, DEFAULT_RING) if ring is None else ring,
        worst_k=(
            _env_pos_int(_ENV_WORST_K, DEFAULT_WORST_K)
            if worst_k is None
            else worst_k
        ),
        window_s=(
            _env_pos_float(_ENV_WINDOW_S, DEFAULT_WINDOW_S)
            if window_s is None
            else window_s
        ),
    )
    _BUFFER = buf
    return buf


def clear() -> None:
    """Disarm entirely (buffer and retained traces dropped)."""
    global _BUFFER
    _BUFFER = None


def ensure_from_env() -> RequestTraceBuffer | None:
    """Arm from ``PHOTON_TRACE=1`` unless already armed (programmatic
    :func:`install` wins). The scorer/trainer/engine entry points call
    this, so env-armed runs need no code change. Loud on bad values."""
    if _BUFFER is not None:
        return _BUFFER
    raw = os.environ.get(_ENV_ARM, "").strip()
    if not raw or raw == "0":
        return None
    if raw != "1":
        raise ValueError(f"{_ENV_ARM} must be '1' or '0'/unset, got {raw!r}")
    return install()


def reset_run_state() -> None:
    """Per-run reset hook for ``obs.reset()``."""
    if _BUFFER is not None:
        _BUFFER.reset_run_state()


def null() -> _NullCtx:
    """The shared no-op context (what :func:`mint` returns disarmed)."""
    return _NULL


def mint(name: str, kind: str = "request"):
    """Mint one request/chunk trace — disarmed, this is two module-global
    reads returning the shared null context."""
    buf = _BUFFER
    if buf is None:
        return _NULL
    return buf.mint(name, kind)


def group(name: str, members, **args):
    """A shared fan-in group over ``members`` (TraceCtx or None each)."""
    buf = _BUFFER
    if buf is None:
        return _NULL
    return buf.group(name, members, **args)


def mark(name: str, **args) -> None:
    """A global lifecycle instant (hot-swap flips, drains)."""
    buf = _BUFFER
    if buf is None:
        return
    buf.instant(name, **args)


def mark_fault(point: str, kind: str) -> None:
    """Called from ``faults.fault_point`` on the FIRED path only."""
    buf = _BUFFER
    if buf is None:
        return
    buf.mark_fault(point, kind)


def current_trace_id() -> int | None:
    """The trace ID active on this thread (None when disarmed or no
    trace is active) — the tracer keeps it on each span record
    (``SpanRecord.trace_id``), and a device trace joined to the records
    carries it (``export.join_device_trace``)."""
    if _BUFFER is None:
        return None
    stack = _tls_stack()
    if not stack:
        return None
    return getattr(stack[-1], "trace_id", None)


# -- export + schema contract ------------------------------------------------


def _to_chrome(ev: dict, pid: int, epoch_ns: int) -> dict:
    out = {
        "name": ev["name"],
        "cat": ev["cat"],
        "ph": ev["ph"],
        "pid": pid,
        "tid": ev["tid"],
        "ts": (ev["t_ns"] - epoch_ns) / 1e3,
    }
    if ev["ph"] == "X":
        out["dur"] = ev["dur_ns"] / 1e3
    elif ev["ph"] == "i":
        out["s"] = "t"
    if "id" in ev:
        out["id"] = ev["id"]
        if ev["ph"] == "f":
            out["bp"] = "e"  # bind the arrowhead to the enclosing slice
    if ev["args"]:
        out["args"] = dict(ev["args"])
    return out


def chrome_trace(meta: dict | None = None) -> dict:
    """The retained causal traces as one Perfetto-loadable Chrome-trace
    document (served by ``/trace``; exported as ``trace_exemplars.json``).
    Always returns a valid document — disarmed it is just metadata.

    Flow hygiene: a trace that never reached its terminal stage (shed at
    the door before fan-in) has a dangling flow; its flow events are
    dropped at export (slices and instants stay) so every exported flow
    ``id`` resolves — the schema contract CI validates."""
    from photon_tpu_torch import obs

    tracer = obs.get_tracer()
    pid, epoch_ns = tracer.pid, tracer.epoch_ns
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "photon-tpu"},
        }
    ]
    other: dict = {"causal_tracing": {"armed": _BUFFER is not None}}
    buf = _BUFFER
    if buf is not None:
        traces, instants, names, stats = buf.export_state()
        other["causal_tracing"].update(stats)
        other["causal_tracing"]["traces"] = [
            {
                "trace_id": t.trace_id,
                "name": t.name,
                "kind": t.kind,
                "outcome": t.outcome,
                "e2e_s": None if t.e2e_s is None else round(t.e2e_s, 6),
                "sampled": t.sampled,
            }
            for t in traces
        ]
        for tid, nm in sorted(names.items()):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": nm},
                }
            )
        raw: list[dict] = list(instants)
        seen_groups: set[int] = set()
        for t in traces:
            raw.extend(t.events)
            for g in t.shared:
                if id(g) not in seen_groups:
                    seen_groups.add(id(g))
                    raw.extend(g.events)
        # drop dangling flows: only ids carrying both a start and a
        # finish survive (no dangling bind IDs in the export)
        phases: dict[int, set] = {}
        for ev in raw:
            if ev["ph"] in _FLOW_PHASES:
                phases.setdefault(ev["id"], set()).add(ev["ph"])
        resolved = {
            i for i, p in phases.items() if "s" in p and "f" in p
        }
        body = [
            _to_chrome(ev, pid, epoch_ns)
            for ev in raw
            if ev["ph"] not in _FLOW_PHASES or ev["id"] in resolved
        ]
        body.sort(key=lambda e: e["ts"])
        events.extend(body)
    if meta:
        other.update(meta)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def validate_chrome_trace(doc: dict) -> list[str]:
    """The golden Chrome-trace schema contract (empty list = valid):
    required keys per event, known phases only, every flow ``id``
    resolves (has both ``s`` and ``f``), and every flow event binds
    inside a complete slice on its own pid/tid track."""
    errs: list[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    slices: dict[tuple, list] = {}
    flows: list[dict] = []
    for i, ev in enumerate(evs):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                errs.append(f"event[{i}] missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "s", "t", "f"):
            errs.append(f"event[{i}] unknown phase {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errs.append(f"event[{i}] ({ev.get('name')}) missing numeric ts")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(
                    f"event[{i}] ({ev.get('name')}) X slice needs dur >= 0"
                )
                continue
            slices.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (ts, ts + dur)
            )
        elif ph == "i":
            if ev.get("s") not in ("t", "p", "g"):
                errs.append(
                    f"event[{i}] ({ev.get('name')}) instant scope "
                    f"{ev.get('s')!r} not one of t/p/g"
                )
        else:  # flow
            if "id" not in ev:
                errs.append(f"event[{i}] flow {ph!r} missing id")
            else:
                flows.append(ev)
    ids: dict = {}
    for ev in flows:
        ids.setdefault(ev["id"], set()).add(ev["ph"])
    for fid in sorted(ids, key=str):
        have = ids[fid]
        if "s" not in have:
            errs.append(f"flow id {fid} dangling: no start ('s') event")
        if "f" not in have:
            errs.append(f"flow id {fid} dangling: no finish ('f') event")
    for ev in flows:
        track = slices.get((ev.get("pid"), ev.get("tid")), [])
        ts = ev.get("ts")
        if not any(lo <= ts <= hi for lo, hi in track):
            errs.append(
                f"flow {ev['ph']!r} id {ev['id']} at ts={ts} binds to no "
                f"slice on pid={ev.get('pid')} tid={ev.get('tid')}"
            )
    return errs
