"""Runtime telemetry: spans, metrics, exporters, the live plane, health.

Counterpart of photon_tpu/obs. The module-level functions work on ONE
process-global pipeline (a :class:`Tracer` and a :class:`MetricsRegistry`)
behind one enable switch, so instrumentation sites stay one-liners::

    from photon_tpu_torch import obs

    obs.enable()
    with obs.span("fit", grid=3):
        ...
    obs.write_chrome_trace("run.trace.json")

- :mod:`.tracer`: nestable, thread-safe spans; each recorded span enters
  ``torch.profiler.record_function``, so host spans line up with device
  work in a ``torch.profiler`` trace, and ``export.join_device_trace``
  joins that trace back to the span records (args, ids) on one clock;
- :mod:`.metrics`: counters, gauges and log-bucket histograms;
- :mod:`.export`: Chrome trace-event JSON, the metrics snapshot, the JSONL
  run manifest, partial artifacts after a failure, summary tables;
- :mod:`.memory`: the caching allocator's censuses and the transfer bill;
- :mod:`.slo`: latency objectives, burn rates, stage attribution;
- :mod:`.health`: the divergence monitor of the descent loop.

- :mod:`.causal`: request- and chunk-scoped causal traces with flow
  links and tail exemplars (``PHOTON_TRACE``), served by ``/trace``.

The live half, composed per run by :class:`LiveTelemetryPlane`:
:mod:`.flight` (the crash-surviving mmap ring, blackbox dumps, stale-ring
recovery after a SIGKILL), :mod:`.series` (periodic ``series.jsonl``
rows), :mod:`.fleet` (the cross-process plane of a meshed fit:
heartbeats, per-sweep skew, the aggregate families, the device-time
breakdown; ``PHOTON_OBS_FLEET``, on by itself in a world of more than one
rank) and :mod:`.http` (``/metrics``, ``/healthz``, ``/slo``, ``/trace``,
``/blackbox`` on ``PHOTON_OBS_HTTP_PORT``).

Telemetry is DISABLED by default (``PHOTON_OBS=1`` enables it at import,
or call :func:`enable`). A disabled span still measures its wall but
records nothing and takes no lock. No mode of telemetry launches device
work. One telemetry-only read synchronizes with the card:
``optimize.common.record_optimize_metrics`` (the single-GLM path) reads a
solve's four counters back while telemetry is on, counted at the sync
site ``optimize.counters``. Every blocking read on the fit's path goes
through :class:`host_sync`, which counts it per site whether or not
telemetry is on, and times the host's wait in it while telemetry is on.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

from photon_tpu_torch.obs import causal, fleet, flight, health, http, memory, series, slo
from photon_tpu_torch.obs.export import (
    chrome_trace,
    export_artifacts,
    export_partial_artifacts,
    histogram_summary,
    phase_summary,
    summary_table,
    write_chrome_trace,
    write_memory_report,
    write_metrics,
    write_run_manifest,
)
from photon_tpu_torch.obs.metrics import MetricsRegistry
from photon_tpu_torch.obs.tracer import Span, Tracer

__all__ = [
    "LiveTelemetryPlane",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "causal",
    "chrome_trace",
    "counter",
    "disable",
    "dispatch_count",
    "dispatch_site",
    "enable",
    "enabled",
    "export_artifacts",
    "export_partial_artifacts",
    "fleet",
    "flight",
    "gauge",
    "get_registry",
    "get_tracer",
    "health",
    "histogram",
    "histogram_summary",
    "host_sync",
    "http",
    "instant",
    "live_plane",
    "memory",
    "phase_summary",
    "record_dispatch",
    "reset",
    "series",
    "slo",
    "span",
    "stage",
    "stage_walls",
    "summary_table",
    "sync_snapshot",
    "syncs_since",
    "tally",
    "write_chrome_trace",
    "write_memory_report",
    "write_metrics",
    "write_run_manifest",
]

logger = logging.getLogger(__name__)

_tracer = Tracer(enabled=os.environ.get("PHOTON_OBS", "") == "1")
_registry = MetricsRegistry()

def get_tracer() -> Tracer:
    """The process-global default tracer."""
    return _tracer


def get_registry() -> MetricsRegistry:
    """The process-global default metrics registry."""
    return _registry


def enabled() -> bool:
    return _tracer.enabled


def enable() -> None:
    """Turn the global telemetry pipeline on."""
    _tracer.enabled = True


def disable() -> None:
    _tracer.enabled = False


def reset() -> None:
    """Drop every recorded span, zero the registry, and clear the memory
    ledger's, the fleet plane's (its breakdown and sweep-log reads), the
    SLO tracker's and the causal buffer's per-run state (the artifact
    boundary; warm-up footprints, an armed SLO spec and an armed trace
    plane with its knobs survive)."""
    _tracer.clear()
    _registry.clear()
    memory.get_ledger().reset_run_state()
    fleet.clear_breakdown()
    fleet.clear_sweeps_cache()
    slo.reset_run_state()
    causal.reset_run_state()


def span(name: str, cat: str = "phase", **args) -> Span:
    """A span on the default tracer: always measures, records only when
    telemetry is enabled."""
    return _tracer.span(name, cat=cat, **args)


def instant(name: str, cat: str = "event", **args) -> None:
    """Record an instant (zero-duration) event when enabled."""
    _tracer.instant(name, cat=cat, **args)


def counter(name: str, value: float = 1.0) -> None:
    """Bump a counter on the default registry (no-op while disabled)."""
    if _tracer.enabled:
        _registry.counter(name, value)


def tally(name: str, value: float = 1.0) -> None:
    """Bump a counter on the default registry whether or not telemetry is
    on (a count that a run reads back with telemetry off, as
    :class:`host_sync` counts its sites always)."""
    _registry.counter(name, value)


def gauge(name: str, value: float) -> None:
    """Set a gauge on the default registry (no-op while disabled)."""
    if _tracer.enabled:
        _registry.gauge(name, value)


def histogram(name: str, value: float) -> None:
    """Observe a histogram sample on the default registry (no-op while
    disabled)."""
    if _tracer.enabled:
        _registry.histogram(name, value)


#: coordinate-level launch sites counted so far (see record_dispatch)
_dispatches = 0
_dispatch_lock = threading.Lock()
_dispatch_tls = threading.local()


def record_dispatch() -> None:
    """Count one launch site on the descent's work counter, mirrored as the
    ``descent.dispatches`` counter while telemetry is enabled. The sites
    are the port's counterparts of the places where JAX counts a compiled
    program launch (``photon_tpu/util/dispatch_count.py``): a coordinate's
    sweep step, a coordinate's score or train called on its own, the
    injected NaN, and each chunk a streaming coordinate dispatches. It
    counts coordinate-level launch SITES, so on the same fit it equals
    JAX's count; it is not the number of CUDA kernels a site launches
    (``chip_smoke.py --profile`` counts those). Always counted: a sweep
    row's ``dispatches`` does not depend on telemetry being on. Inside a
    :func:`dispatch_site` on this thread it counts nothing."""
    global _dispatches
    if getattr(_dispatch_tls, "depth", 0):
        return
    with _dispatch_lock:
        _dispatches += 1
    counter("descent.dispatches")


@contextlib.contextmanager
def dispatch_site():
    """One launch site around work whose own sites count as part of it (a
    coordinate's sweep step around its train and score, as JAX's fused
    step program is one launch)."""
    record_dispatch()
    _dispatch_tls.depth = getattr(_dispatch_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _dispatch_tls.depth -= 1


def dispatch_count() -> int:
    """The cumulative count of :func:`record_dispatch` (monotonic: a sweep
    or a fit reports the difference of two reads)."""
    return _dispatches


_stage_tls = threading.local()


@contextlib.contextmanager
def stage_walls():
    """Sum the walls of the :func:`stage` spans that close on this thread
    inside, by name, into the dict it yields (measured whether or not
    telemetry is on: a fit's ``last_fit_stats["build_stages"]``)."""
    walls: dict[str, float] = {}
    prev = getattr(_stage_tls, "walls", None)
    _stage_tls.walls = walls
    try:
        yield walls
    finally:
        _stage_tls.walls = prev


@contextlib.contextmanager
def stage(name: str, cat: str = "build", **args):
    """A :func:`span` whose wall also adds to the innermost
    :func:`stage_walls` open on this thread (a stage of a host build)."""
    with _tracer.span(name, cat=cat, **args) as sp:
        yield sp
    walls = getattr(_stage_tls, "walls", None)
    if walls is not None:
        walls[name] = walls.get(name, 0.0) + sp.duration_s


#: cumulative blocking reads of the card per site, and (telemetry on
#: only) the host's wait in them in ns (see host_sync)
_syncs: dict[str, int] = {}
_sync_wait_ns: dict[str, int] = {}
_sync_lock = threading.Lock()


class host_sync:
    """Around ONE blocking read of the card (``bool(t.any())``, a
    device-to-host copy, a ``synchronize``) at a named site::

        with obs.host_sync("lbfgs.iteration"):
            # phl-ok: PHL002 ...
            go = bool(active.any())

    Counted per site always, as :func:`record_dispatch` counts (one
    integer bump under one lock); while telemetry is on the read is also
    timed with ``perf_counter_ns`` and both are mirrored as the counters
    ``sync.<site>`` and ``sync_wait_s.<site>``. It launches nothing and
    adds no sync of its own: the read stays at its annotated line.
    :func:`sync_snapshot` reads the cumulative totals and
    :func:`syncs_since` their differences over a step."""

    __slots__ = ("site", "_t0")

    def __init__(self, site: str):
        self.site = site
        self._t0 = 0

    def __enter__(self) -> "host_sync":
        if _tracer.enabled:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        site, wait = self.site, 0
        if self._t0:
            wait = time.perf_counter_ns() - self._t0
        with _sync_lock:
            _syncs[site] = _syncs.get(site, 0) + 1
            if wait:
                _sync_wait_ns[site] = _sync_wait_ns.get(site, 0) + wait
        if wait:
            _registry.counter(f"sync.{site}")
            _registry.counter(f"sync_wait_s.{site}", wait / 1e9)


def sync_snapshot() -> tuple[dict[str, int], dict[str, int]]:
    """The cumulative blocking reads per site and the host's cumulative
    wait in them per site in ns (timed while telemetry was on: a site read
    only with telemetry off has no wait), for :func:`syncs_since`."""
    with _sync_lock:
        return dict(_syncs), dict(_sync_wait_ns)


def syncs_since(snapshot: tuple[dict, dict]) -> tuple[dict[str, int], dict[str, float]]:
    """``(counts, wait_s)`` per site since ``snapshot``, sites that moved only."""
    counts0, waits0 = snapshot
    counts, waits = sync_snapshot()
    return ({k: n - counts0.get(k, 0) for k, n in counts.items() if n != counts0.get(k, 0)},
            {k: (w - waits0.get(k, 0)) / 1e9 for k, w in waits.items()
             if w != waits0.get(k, 0)})


class LiveTelemetryPlane:
    """The always-on half of telemetry for ONE run directory: stale-ring
    recovery (what a killed previous run was doing, as ``blackbox-
    <seq>.json``), the mmap flight recorder with its crash handlers, and
    the series flusher, the fleet publisher (a multi-process run, or
    ``PHOTON_OBS_FLEET=1``) and the opt-in HTTP endpoints
    (``PHOTON_OBS_HTTP_PORT``), started together and torn down together
    (LIFO, each step guarded: telemetry never fails or outlives the run).
    ``PHOTON_OBS_RING_MB=0`` and ``PHOTON_OBS_FLUSH_S=0`` turn pieces off;
    an unset port opens no socket. A port that cannot be bound fails the
    start loudly, never a plane that quietly runs without its endpoints.
    """

    def __init__(self, directory):
        self.directory = str(directory)
        self.recovered_blackbox: str | None = None
        self.recorder = None
        self.flusher = None
        self.server = None
        self.fleet_publisher = None

    def start(self) -> "LiveTelemetryPlane":
        """Arm the plane. If a step fails (a bad knob), every piece armed
        so far is torn down before the error propagates."""
        try:
            os.makedirs(self.directory, exist_ok=True)
            self.recovered_blackbox = flight.recover_stale(self.directory)
            self.recorder = flight.enable(self.directory)
            if self.recorder is not None:
                flight.install_crash_handler()
            self.flusher = series.start_flusher(os.path.join(self.directory, "series.jsonl"))
            # fleet membership: heartbeats and the sweep log, None in a
            # single-process run unless PHOTON_OBS_FLEET=1
            self.fleet_publisher = fleet.start_publisher(self.directory)
            self.server = http.start_from_env()
        except BaseException:
            self.close()
            raise
        return self

    def close(self) -> None:
        for step in (http.stop_server, fleet.stop_publisher, series.stop_flusher,
                     flight.uninstall_crash_handler, flight.disable):
            try:
                step()
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("telemetry-plane teardown step %s failed: %s: %s",
                               step.__name__, type(e).__name__, e)


def live_plane(directory) -> LiveTelemetryPlane:
    """Start a :class:`LiveTelemetryPlane` under ``directory``."""
    return LiveTelemetryPlane(directory).start()
