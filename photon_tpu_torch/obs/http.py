"""Live telemetry endpoints: /metrics, /healthz, /slo, /trace, /blackbox.

Counterpart of photon_tpu/obs/http.py. An opt-in stdlib ``http.server``
thread (``PHOTON_OBS_HTTP_PORT``; default off — unset means no socket is
ever opened, ``0`` an ephemeral port) that serves the process-global obs
pipeline LIVE, so a long fit or an always-on serving loop is observable
while it runs instead of only after it exports. It binds to
``127.0.0.1``.

- ``/metrics`` — the :class:`~photon_tpu_torch.obs.metrics.MetricsRegistry`
  in Prometheus text exposition format (counters as ``*_total``,
  gauges, histograms as summaries with p50/p90/p99/p99.9 quantile lines
  from the sparse log buckets); with a fleet publisher armed, also every
  process's families as ``photon_proc_*{process="k"}`` and their
  aggregate as ``photon_fleet_*`` (:func:`fleet_prometheus_text`). Counter samples stay MONOTONIC across
  ``registry.clear()`` (a driver resets at each run boundary; a scraper
  must see a cumulative series, not a sawtooth) via per-name reset
  compensation.
- ``/healthz`` — JSON: last per-coordinate health scalars (the values
  the per-sweep barrier fetched), divergence state, ``recovery.*``
  restart counters, producer-watchdog liveness, series-flusher and
  flight-recorder liveness, the latency-SLO state (armed spec,
  violation count, burn rates) and, with a fleet publisher armed
  (obs/fleet.py), the ``fleet`` section: the worker heartbeat table with
  stale and dead workers, the per-sweep skew and the stragglers (null
  without a publisher).
- ``/slo`` — the full latency-SLO document
  (:func:`photon_tpu_torch.obs.slo.report`).
- ``/trace`` — the retained causal traces (obs/causal.py) as
  Perfetto-loadable Chrome-trace JSON.
- ``/blackbox`` — the flight recorder's recent ring as JSON.

Every response is built from host state under the owners' locks; a
scrape launches no device work and never synchronizes with the card.
Zero new dependencies: the exposition writer AND the minimal parser
(:func:`parse_prometheus_text`, a ``text_string_to_metric_families``-
style reader) are vendored here. The server thread is owned by
:class:`TelemetryServer`, whose ``stop()`` (finally-guarded by the
drivers' ``run_profile``) shuts the socket down and joins the thread.
"""
from __future__ import annotations

import json
import logging
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from photon_tpu_torch.obs.metrics import SUMMARY_PERCENTILES

logger = logging.getLogger(__name__)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")

#: every exported sample is namespaced under this prefix
PREFIX = "photon_"


def http_port() -> int | None:
    """Configured endpoint port (env ``PHOTON_OBS_HTTP_PORT``): None =
    off (the default — no socket), 0 = ephemeral OS-assigned port."""
    env = os.environ.get("PHOTON_OBS_HTTP_PORT", "").strip()
    if not env:
        return None
    try:
        port = int(env)
    except ValueError as e:
        raise ValueError(
            f"PHOTON_OBS_HTTP_PORT must be an integer port, got {env!r}"
        ) from e
    if port < 0 or port > 65535:
        raise ValueError(f"PHOTON_OBS_HTTP_PORT out of range: {port}")
    return port


def sanitize_metric_name(name: str) -> str:
    """A Prometheus-legal sample name for a dotted registry name:
    ``score.batch_seconds`` → ``photon_score_batch_seconds``. Illegal
    characters collapse to ``_``; the ``photon_`` namespace prefix also
    makes a leading digit legal."""
    s = PREFIX + _BAD_CHARS.sub("_", name)
    assert _NAME_OK.match(s), s
    return s


class CounterMonotonicity:
    """Reset compensation for counter samples: the registry's counters
    zero on ``clear()`` (per-config bench resets, driver run
    boundaries), but a Prometheus counter series must never decrease.
    Tracks a per-name base and folds the pre-reset total in whenever the
    raw value goes backwards."""

    def __init__(self):
        self._base: dict[str, float] = {}
        self._last: dict[str, float] = {}
        self._lock = threading.Lock()

    def adjust(self, name: str, value: float) -> float:
        with self._lock:
            last = self._last.get(name, 0.0)
            if value < last:  # the registry was reset since the last scrape
                self._base[name] = self._base.get(name, 0.0) + last
            self._last[name] = value
            return self._base.get(name, 0.0) + value


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):  # a diverged gnorm gauge overflows to inf
        return "+Inf"  # before it NaNs — the scrape must render, not 500
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def prometheus_text(
    snapshot: dict, monotonic: CounterMonotonicity | None = None
) -> str:
    """Render a ``MetricsRegistry.snapshot()`` dict as Prometheus text
    exposition format (one ``# TYPE`` line per family; counters suffixed
    ``_total``; histograms as summaries with quantile labels from their
    sparse-log-bucket percentiles)."""
    lines: list[str] = []
    for name in sorted(snapshot.get("counters", {})):
        value = snapshot["counters"][name]
        if monotonic is not None:
            value = monotonic.adjust(name, value)
        base = sanitize_metric_name(name)
        if not base.endswith("_total"):
            base += "_total"
        lines.append(f"# TYPE {base} counter")
        lines.append(f"{base} {_fmt(value)}")
    for name in sorted(snapshot.get("gauges", {})):
        base = sanitize_metric_name(name)
        lines.append(f"# TYPE {base} gauge")
        lines.append(f"{base} {_fmt(snapshot['gauges'][name])}")
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        base = sanitize_metric_name(name)
        lines.append(f"# TYPE {base} summary")
        for p in SUMMARY_PERCENTILES:
            q = h.get(f"p{p}")
            if q is None:
                continue
            lines.append(
                f'{base}{{quantile="{p / 100.0:g}"}} {_fmt(q)}'
            )
        # _sum/_count are CUMULATIVE in Prometheus semantics — they need
        # the same reset compensation as counters or a registry.clear()
        # (per-config bench resets) reads as a sawtooth to rate()
        # (quantile lines are point-in-time, no adjustment)
        h_sum = h.get("sum", 0.0)
        h_count = h.get("count", 0)
        if monotonic is not None:
            h_sum = monotonic.adjust(f"{name}:sum", h_sum)
            h_count = monotonic.adjust(f"{name}:count", h_count)
        lines.append(f"{base}_sum {_fmt(h_sum)}")
        lines.append(f"{base}_count {_fmt(h_count)}")
    return "\n".join(lines) + "\n"


def fleet_prometheus_text(
    monotonic: CounterMonotonicity | None = None,
) -> str:
    """The FLEET half of a ``/metrics`` scrape (empty string when no
    fleet publisher is armed): per-process families re-exported with
    ``{process=,host=}`` labels under a ``photon_proc_`` prefix (so they
    never collide with this process's own unlabeled families — duplicate
    ``# TYPE`` lines are illegal exposition), plus aggregate
    ``photon_fleet_*`` families merged by :mod:`photon_tpu_torch.obs.fleet`
    (counters summed, histogram summaries from the bucket-exact merge —
    the acceptance contract is ``photon_fleet_x_total == Σ
    photon_proc_x_total{process=k}``, scraped from ONE endpoint).
    Counter-monotonicity compensation applies per (process, name) and to
    the aggregate, so a worker's ``registry.clear()`` can't read as a
    counter going backwards."""
    from photon_tpu_torch.obs import fleet

    root = fleet.get_fleet_root()
    if root is None:
        return ""
    docs = fleet.read_worker_docs(root)
    if not docs:
        return ""
    lines: list[str] = []

    def adj(scope: str, name: str, value: float) -> float:
        if monotonic is None:
            return value
        return monotonic.adjust(f"{scope}:{name}", value)

    def labels(doc: dict) -> str:
        return (
            f'{{process="{doc.get("process_index")}"'
            f',host="{doc.get("host", "")}"}}'
        )

    # -- per-process families (photon_proc_*) -----------------------------
    counter_names = sorted(
        {
            n
            for d in docs
            for n in ((d.get("metrics") or {}).get("counters") or {})
        }
    )
    for name in counter_names:
        base = sanitize_metric_name(name).replace(PREFIX, PREFIX + "proc_", 1)
        if not base.endswith("_total"):
            base += "_total"
        lines.append(f"# TYPE {base} counter")
        for d in docs:
            v = ((d.get("metrics") or {}).get("counters") or {}).get(name)
            if v is None:
                continue
            v = adj(f"p{d.get('process_index')}", name, v)
            lines.append(f"{base}{labels(d)} {_fmt(v)}")
    gauge_names = sorted(
        {
            n
            for d in docs
            for n in ((d.get("metrics") or {}).get("gauges") or {})
        }
    )
    for name in gauge_names:
        base = sanitize_metric_name(name).replace(PREFIX, PREFIX + "proc_", 1)
        lines.append(f"# TYPE {base} gauge")
        for d in docs:
            g = (d.get("metrics") or {}).get("gauges") or {}
            if name in g:
                lines.append(f"{base}{labels(d)} {_fmt(g[name])}")

    # -- aggregate families (photon_fleet_*) ------------------------------
    merged = fleet.merge_snapshots([d.get("metrics") or {} for d in docs])
    for name in sorted(merged["counters"]):
        base = sanitize_metric_name(name).replace(
            PREFIX, PREFIX + "fleet_", 1
        )
        if not base.endswith("_total"):
            base += "_total"
        lines.append(f"# TYPE {base} counter")
        lines.append(
            f"{base} {_fmt(adj('fleet', name, merged['counters'][name]))}"
        )
    for name in sorted(merged["histograms"]):
        h = merged["histograms"][name]
        base = sanitize_metric_name(name).replace(
            PREFIX, PREFIX + "fleet_", 1
        )
        lines.append(f"# TYPE {base} summary")
        for p in SUMMARY_PERCENTILES:
            q = h.get(f"p{p}")
            if q is not None:
                lines.append(f'{base}{{quantile="{p / 100.0:g}"}} {_fmt(q)}')
        lines.append(
            f"{base}_sum {_fmt(adj('fleet', name + ':sum', h.get('sum', 0.0)))}"
        )
        lines.append(
            f"{base}_count "
            f"{_fmt(adj('fleet', name + ':count', h.get('count', 0)))}"
        )
    return "\n".join(lines) + "\n" if lines else ""


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\d+)?$"
)


def parse_prometheus_text(text: str) -> dict[str, dict]:
    """Minimal vendored Prometheus text-format parser (the shape of
    ``prometheus_client.parser.text_string_to_metric_families``, without
    the dependency): returns ``{family_name: {"type": str, "samples":
    [(sample_name, {label: value}, float)]}}``. Raises ``ValueError`` on
    a malformed line — the golden-file test uses that strictness as the
    schema check."""
    families: dict[str, dict] = {}

    def family_for(sample_name: str) -> dict:
        # a counter family "x_total"'s samples keep the suffix; summary
        # samples "x_sum"/"x_count" fold into family "x"
        for fam in families.values():
            base = fam["_base"]
            if sample_name == base or (
                fam["type"] == "summary"
                and sample_name in (base + "_sum", base + "_count")
            ):
                return fam
        raise ValueError(f"sample {sample_name!r} precedes its # TYPE line")

    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("# HELP"):
            continue
        if line.startswith("# TYPE"):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            _, _, name, mtype = parts
            if mtype not in ("counter", "gauge", "summary", "histogram"):
                raise ValueError(f"line {lineno}: unknown type {mtype!r}")
            families[name] = {"type": mtype, "samples": [], "_base": name}
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name = m.group("name")
        labels: dict[str, str] = {}
        if m.group("labels"):
            for pair in m.group("labels").split(","):
                pair = pair.strip()
                if not pair:
                    continue
                k, _, v = pair.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(
                        f"line {lineno}: unquoted label value: {line!r}"
                    )
                labels[k.strip()] = v[1:-1]
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: non-numeric value: {line!r}"
            ) from e
        family_for(name)["samples"].append((name, labels, value))
    for fam in families.values():
        fam.pop("_base", None)
    return families


# -- /healthz ---------------------------------------------------------------


def slo_health_section() -> dict:
    """The latency-SLO slice of ``/healthz``: armed spec, violation
    census, burn rates, and a one-word status — ``ok`` / ``violating``
    (any burn window over 1.0, or any violation with no window data
    yet) / ``unarmed``. Pure host reads of the tracker state."""
    from photon_tpu_torch.obs import slo

    tracker = slo.ensure_from_env()
    if tracker is None:
        return {"status": "unarmed", "spec": None}
    burn = tracker.burn_rates()
    rates = [b["rate"] for b in burn.values()]
    burning = any(r is not None and r > 1.0 for r in rates)
    # violations with NO live window data (the breach aged out of every
    # burn window, e.g. an idle process after a bad burst) must still
    # read as violating — nothing observed since says it recovered
    if tracker.violations and all(r is None for r in rates):
        burning = True
    return {
        "status": "violating" if burning else "ok",
        "spec": tracker.spec.render(),
        "batches": tracker.batches,
        "violations": tracker.violations,
        "violations_by_stage": dict(tracker.by_stage),
        "burn_rates": burn,
    }


def healthz_snapshot(registry=None) -> dict:
    """The liveness/health document ``/healthz`` serves, built from the
    registry plus the flight recorder's and series flusher's own state.
    Pure host reads — serving a scrape can never touch the device."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import fleet as obs_fleet
    from photon_tpu_torch.obs import flight, series

    snap = (registry or obs.get_registry()).snapshot()
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    divergences = counters.get("health.divergence", 0)
    proc = obs_fleet.process_info()
    doc = {
        "status": "diverged" if divergences else "ok",
        "pid": os.getpid(),
        "process_index": proc.index,
        "process_count": proc.count,
        "host": proc.host,
        "divergences": divergences,
        "health_checks": counters.get("health.checks", 0),
        "health": flight.last_health(),
        "health_gauges": {
            k: v for k, v in sorted(gauges.items()) if k.startswith("health.")
        },
        "recovery": {
            "restarts": counters.get("recovery.restarts", 0),
            "recovered": counters.get("recovery.recovered", 0),
            "giveup": counters.get("recovery.giveup", 0),
            "failures": {
                k.split(".", 2)[2]: v
                for k, v in counters.items()
                if k.startswith("recovery.failures.")
            },
        },
        "watchdog": {
            "producer_deaths": counters.get("score.producer_deaths", 0),
            "stream_stalls": counters.get("score.stream_stalls", 0),
            "batch_retries": counters.get("score.batch_retries", 0),
        },
        "slo": slo_health_section(),
    }
    # the serving engine's admission/shed/swap censuses — present only
    # when a serve plane has actually counted something, so training and
    # scoring processes keep their /healthz shape
    if any(k.startswith("serve.") for k in counters):
        doc["serve"] = {
            "admitted": counters.get("serve.admitted", 0),
            "requests": counters.get("serve.requests", 0),
            "batches": counters.get("serve.batches", 0),
            "shed": counters.get("serve.shed", 0),
            "shed_by_reason": {
                k.split(".", 2)[2]: v
                for k, v in sorted(counters.items())
                if k.startswith("serve.shed.")
                and not k.startswith("serve.shed.tenant.")
            },
            "shed_by_tenant": {
                k.split(".", 3)[3]: v
                for k, v in sorted(counters.items())
                if k.startswith("serve.shed.tenant.")
            },
            "requests_by_tenant": {
                k.split(".", 3)[3]: v
                for k, v in sorted(counters.items())
                if k.startswith("serve.requests.tenant.")
            },
            "dispatch_failures": counters.get("serve.dispatch_failures", 0),
            "batch_retries": counters.get("serve.batch_retries", 0),
            "swaps": counters.get("serve.swaps", 0),
            "swap_rollbacks": counters.get("serve.swap_rollbacks", 0),
            "evicted": counters.get("serve.evicted", 0),
        }
    rec = flight.get_recorder()
    doc["recorder"] = (
        None
        if rec is None
        else {"last_seq": rec.last_seq(), "dropped": rec.dropped}
    )
    flusher = series.get_flusher()
    doc["flusher"] = (
        None
        if flusher is None
        else {
            "rows": flusher.rows_written,
            "interval_s": flusher.interval_s,
            "last_flush_age_s": flusher.last_flush_age_s(),
        }
    )
    # the fleet section: the worker heartbeat table (a silent or dead
    # worker shows here, on the process that is often the only one left to
    # scrape) and the live skew and straggler view, from host file reads
    root = obs_fleet.get_fleet_root()
    if root is None:
        doc["fleet"] = None
    else:
        workers = obs_fleet.workers_summary(root)
        skew = obs_fleet.compute_skew(obs_fleet.read_sweeps(root))
        doc["fleet"] = {
            "root": root,
            "workers": workers,
            "stale": [w["process_index"] for w in workers if w["status"] == "stale"],
            "dead": [w["process_index"] for w in workers if w["status"] == "dead"],
            "stale_after_s": obs_fleet.stale_after_s(),
            "sweeps_joined": len(skew),
            "max_skew_ratio": obs_fleet.max_skew_ratio(skew),
            "stragglers": sorted({p for r in skew for p in r["stragglers"]}),
            "last_skew": skew[-1] if skew else None,
        }
    return doc


# -- the server -------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server_version = "photon-obs/1"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        try:
            if self.path.split("?")[0] == "/metrics":
                from photon_tpu_torch import obs

                mono = self.server._monotonic  # type: ignore[attr-defined]
                # one scrape: with a fleet publisher armed the response also
                # carries the per-process and the aggregate families
                text = prometheus_text(obs.get_registry().snapshot(), mono)
                body = (text + fleet_prometheus_text(mono)).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/healthz":
                body = (
                    json.dumps(healthz_snapshot(), default=str) + "\n"
                ).encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/slo":
                from photon_tpu_torch.obs import slo

                body = (
                    json.dumps(slo.report(), default=str) + "\n"
                ).encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/trace":
                from photon_tpu_torch.obs import causal

                # Perfetto-loadable Chrome-trace JSON of the retained
                # causal traces (sampled ring + worst-K tail exemplars)
                body = (
                    json.dumps(causal.chrome_trace(), default=str) + "\n"
                ).encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/blackbox":
                from photon_tpu_torch.obs import flight

                rec = flight.get_recorder()
                body = (
                    json.dumps(
                        {
                            "records": [] if rec is None else rec.records(),
                            "last_seq": (
                                -1 if rec is None else rec.last_seq()
                            ),
                        },
                        default=str,
                    )
                    + "\n"
                ).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown endpoint")
                return
        except Exception as e:  # a scrape must never kill the server
            self.send_error(500, f"{type(e).__name__}: {e}")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not stderr events
        logger.debug("obs-http %s", fmt % args)


class TelemetryServer:
    """Owns the endpoint socket + serve thread. ``start()`` returns the
    BOUND port (pass 0 for an OS-assigned one); ``stop()`` shuts down
    and joins — the owner must finally-guard it (``run_profile`` does)."""

    def __init__(self, port: int):
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._monotonic = CounterMonotonicity()

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), _Handler)
        self._httpd._monotonic = self._monotonic  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        # phl-ok: PHL003 run-scoped server thread: stop() shuts it down and joins, and every owner finally-guards stop()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="obs-http",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "obs endpoints live at http://127.0.0.1:%d"
            "{/metrics,/healthz,/slo,/trace,/blackbox}", self.port,
        )
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


_server: TelemetryServer | None = None


def get_server() -> TelemetryServer | None:
    return _server


def start_from_env() -> TelemetryServer | None:
    """Start the endpoint server when ``PHOTON_OBS_HTTP_PORT`` is set
    (and no server is already live); None when the knob is off."""
    global _server
    if _server is not None:
        return _server
    port = http_port()
    if port is None:
        return None
    srv = TelemetryServer(port)
    srv.start()
    _server = srv
    return srv


def stop_server() -> None:
    global _server
    srv = _server
    _server = None
    if srv is not None:
        srv.stop()
