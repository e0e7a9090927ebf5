"""Time-resolved metric series: periodic registry deltas as JSONL.

Counterpart of photon_tpu/obs/series.py; the rows have the same keys. A
background thread appends one row per ``PHOTON_OBS_FLUSH_S`` seconds
(default 10; 0 disables) to ``<output>/obs/series.jsonl``. Each row
carries the counter DELTAS since the previous row (rates are
``delta / interval_s``), the current gauges, and per-histogram count
deltas with the percentiles of that interval's samples (from bucket
deltas, so a tail that degrades late in a run shows in the late rows).
Rows are mirrored into the flight ring (kind ``metrics``), so a crashed
run's blackbox holds its last metric deltas.

Row schema (one JSON object per line)::

    {"kind": "series", "row": <n>, "process_index": <k>, "host": <name>,
     "t_s": <monotonic offset>, "wall_s": <epoch + t_s>,
     "heartbeat_wall_s": <fresh wall stamp>, "interval_s": <measured>,
     "counters": {<name>: <delta>}, "gauges": {<name>: <value>},
     "histograms": {<name>: {"count": <delta>, "p50":..,"p90":..,"p99":..}}}

``process_index`` and ``host`` come from ``fleet.process_info`` (the
fleet plane's one resolution: ``PHOTON_OBS_PROCESS``, then the live
``torch.distributed`` world, then process 0 of 1).
A flush costs one registry snapshot and one small JSON line (host work
only). ``stop()`` joins the thread and writes one final row, so a run
shorter than one interval still yields a point.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from photon_tpu_torch.obs.fleet import process_info

logger = logging.getLogger(__name__)

#: default flush cadence in seconds (``PHOTON_OBS_FLUSH_S`` overrides;
#: 0 disables the flusher)
DEFAULT_FLUSH_S = 10.0


def flush_interval_s() -> float:
    """Configured flush cadence (env ``PHOTON_OBS_FLUSH_S``)."""
    env = os.environ.get("PHOTON_OBS_FLUSH_S", "").strip()
    if not env:
        return DEFAULT_FLUSH_S
    try:
        v = float(env)
    except ValueError as e:
        raise ValueError(
            f"PHOTON_OBS_FLUSH_S must be a number of seconds, got {env!r}"
        ) from e
    if v < 0:
        raise ValueError(f"PHOTON_OBS_FLUSH_S must be >= 0, got {env!r}")
    return v


class SeriesFlusher:
    """Appends periodic registry-delta rows to a JSONL file.

    ``flush_once()`` is callable without the thread (deterministic
    single rows for tests); ``start()`` /
    ``stop()`` run the periodic loop."""

    def __init__(self, path: str, interval_s: float, registry=None):
        from photon_tpu_torch import obs

        self.path = str(path)
        self.interval_s = float(interval_s)
        self._registry = registry or obs.get_registry()
        #: process identity stamped into every row (process 0 of 1 in a
        #: single-process run) so rows from N workers' files remain
        #: attributable after any downstream concatenation
        self._proc = process_info()
        self._obs = obs
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._prev = self._registry.snapshot()
        self.rows_written = 0
        self.errors = 0
        # phl-ok: PHL006 epoch anchor: the one wall capture; rows step from the monotonic base
        self._epoch_wall_s = time.time()
        self._epoch = time.perf_counter()
        self._last_flush = self._epoch

    def last_flush_age_s(self) -> float:
        return time.perf_counter() - self._last_flush

    def flush_once(self) -> dict | None:
        """Compute the delta row since the previous flush, append it,
        and mirror it into the flight ring. Returns the row (None on
        write failure — the flusher must never fail the run)."""
        from photon_tpu_torch.obs import flight
        from photon_tpu_torch.obs.metrics import (
            SUMMARY_PERCENTILES,
            percentile_from_buckets,
        )

        def interval_hist(h: dict, prev: dict) -> dict:
            """Count delta + percentiles of THIS interval's samples:
            bucket-count deltas vs the previous flush (negative deltas
            — a registry.clear() between flushes — clamp away, leaving
            None percentiles for that torn interval). No min/max for
            the interval, so the percentile read is unclamped — still
            within the ±~5% bucket resolution."""
            pb = prev.get("buckets", {})
            db = {}
            for k, c in h.get("buckets", {}).items():
                d = c - pb.get(k, 0)
                if d > 0:
                    db[k] = d
            dcount = sum(db.values())
            return {
                "count": h["count"] - prev.get("count", 0),
                **{
                    f"p{p}": percentile_from_buckets(
                        {"count": dcount, "buckets": db}, p
                    )
                    for p in SUMMARY_PERCENTILES
                },
            }

        with self._lock:
            now = time.perf_counter()
            snap = self._registry.snapshot()
            delta = self._registry.delta(self._prev, snap)
            prev_h = self._prev.get("histograms", {})
            self._prev = snap
            interval = now - self._last_flush
            self._last_flush = now
            row = {
                "kind": "series",
                "row": self.rows_written,
                "process_index": self._proc.index,
                "host": self._proc.host,
                "t_s": round(now - self._epoch, 6),
                "wall_s": round(self._epoch_wall_s + (now - self._epoch), 3),
                # a FRESH wall stamp per flush (wall_s above steps from
                # the start epoch): the liveness signal a reader
                # can age against its own clock
                # phl-ok: PHL006 heartbeat stamps are wall-clock by definition (cross-process aging)
                "heartbeat_wall_s": round(time.time(), 3),
                "interval_s": round(interval, 6),
                "counters": {
                    k: v
                    for k, v in sorted(delta["counters"].items())
                    if v != 0
                },
                "gauges": dict(sorted(delta["gauges"].items())),
                "histograms": {
                    name: interval_hist(h, prev_h.get(name, {}))
                    for name, h in sorted(snap["histograms"].items())
                },
            }
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(row, default=str) + "\n")
            except OSError as e:
                self.errors += 1
                self._obs.counter("obs.flush.errors")
                logger.warning("series flush to %s failed: %s", self.path, e)
                return None
            self.rows_written += 1
        self._obs.counter("obs.flush.rows")
        # the ring mirror is what makes a crashed run's blackbox carry
        # its last metric deltas (flight.record is a no-op w/o recorder)
        flight.record(
            "metrics",
            row=row["row"],
            interval_s=row["interval_s"],
            counters=row["counters"],
        )
        return row

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush_once()

    def start(self) -> "SeriesFlusher":
        if self.interval_s <= 0:
            # Event.wait(0) returns immediately: a zero-interval loop
            # would busy-flush. 0 means "disabled" everywhere else
            # (start_flusher guards it); a direct start() with it
            # is always a caller bug, so fail loudly
            raise ValueError(
                f"SeriesFlusher.start() needs interval_s > 0, got "
                f"{self.interval_s!r} (0 disables the flusher — don't "
                "start one)"
            )
        if self._thread is not None:
            return self
        # phl-ok: PHL003 run-scoped flusher thread: stop() sets the event and joins, and every owner finally-guards stop()
        self._thread = threading.Thread(
            target=self._run, name="obs-series-flush", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop, join the thread, and write one FINAL row (so a
        run shorter than one interval still yields a trajectory point
        and the last partial interval is never lost). If the thread is
        still alive after the join timeout (wedged in an uninterruptible
        filesystem write, holding the flush lock), the final flush is
        SKIPPED — blocking on that same lock would hang the teardown
        forever, the exact unbounded wait the join timeout bounds."""
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                logger.warning(
                    "series flusher still blocked in a flush after 5 s; "
                    "detaching without the final row"
                )
                return
        self.flush_once()


_flusher: SeriesFlusher | None = None


def get_flusher() -> SeriesFlusher | None:
    return _flusher


def start_flusher(path: str, interval_s: float | None = None) -> SeriesFlusher | None:
    """Start the process-global flusher (None when the cadence is 0 or
    one is already running)."""
    global _flusher
    if _flusher is not None:
        return _flusher
    if interval_s is None:
        interval_s = flush_interval_s()
    if interval_s == 0:
        return None
    _flusher = SeriesFlusher(path, interval_s).start()
    return _flusher


def stop_flusher() -> None:
    global _flusher
    f = _flusher
    _flusher = None
    if f is not None:
        f.stop()


def read_series(path: str) -> list[dict]:
    """Rows of a series JSONL file; truncated tail lines (the flush a
    crash interrupted) are skipped, not crashed on."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows
