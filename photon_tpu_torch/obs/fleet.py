"""Fleet observability: the cross-process telemetry plane of a meshed fit.

Counterpart of photon_tpu/obs/fleet.py. A meshed fit of the port is N
processes (one per rank of a ``torch.distributed`` group) running the same
fit; every obs layer below this module is per-process. This module is
the plane that joins them:

- **Namespacing**: :func:`obs_dir` maps a run's ``<out_root>`` to
  ``<out_root>/obs`` for a single process (the layout of every earlier
  run, byte for byte) and ``<out_root>/obs/p<k>`` for process ``k`` of a
  fleet, so rings, series and artifacts never collide.
- **Heartbeats**: each process runs a :class:`FleetPublisher` that
  atomically rewrites ``p<k>/registry.json`` every
  ``PHOTON_OBS_HEARTBEAT_S`` seconds: the metrics snapshot stamped with
  the process index, host, pid and a wall-clock heartbeat. A worker whose
  heartbeat stops aging forward is *stale*, then *dead*.
- **Aggregation**: process 0 (or the offline reader,
  ``python -m photon_tpu_torch.cli.fleet_report``) merges the snapshots
  into one fleet view: counters summed, gauges kept per process, the
  log-bucket histograms merged bucket for bucket
  (:func:`merge_histograms`). ``/metrics`` on process 0 serves the
  per-process families (``{process="k"}``) and the aggregate
  ``photon_fleet_*`` families. Process 0's aggregation runs on the
  publisher's own thread, so it goes on while the main thread waits in a
  collective for a stopped rank (a Gloo or NCCL wait releases the GIL).
- **Skew attribution**: the descent taps :func:`record_sweep` right after
  each sweep's barrier; the publisher appends one row per sweep to
  ``p<k>/sweeps.jsonl`` with the sweep's start and barrier-arrival walls,
  keyed ``(run, iteration)``. :func:`compute_skew` joins the rows across
  processes and flags a worker whose start lags the earliest by more than
  ``PHOTON_FLEET_STRAGGLER_X - 1`` unobstructed sweeps; each run's first
  joined iteration is warm-up and never flags.
- **Device-time breakdown**: :func:`device_time_breakdown` joins the
  mesh's collective census (parallel/mesh.py, priced by analysis/spmd.py)
  and an analytic flop count per warmed program key
  (``Coordinate.program_flops``: a fixed effect 2 flops per nonzero per
  feature pass, a random effect 2·E·rows·d per evaluation of a solve
  shape, MF 2·N·k) with the MEASURED sweep and barrier walls:
  ``barrier_frac`` is measured, the rest of the sweep splits between
  compute and collectives by the cost model (flops at
  ``PHOTON_DEVICE_GFLOPS``, census bytes at ``PHOTON_COMM_GBPS``, by
  default an H100 SXM's published rates where JAX's are a TPU host's).
  JAX prices with XLA's cost analysis and its HLO census, which the port
  has no counterpart of; ``provenance`` says which pricing was used.

With no publisher installed :func:`record_sweep` is two module-global
reads; every publisher write is host file I/O off the hot path (no
launch, no sync: a fit with the publisher armed has the same
``dispatches`` and the same model, bit for bit).
"""
from __future__ import annotations

import glob
import json
import logging
import os
import socket
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping

logger = logging.getLogger(__name__)

REGISTRY_FILENAME = "registry.json"
SWEEPS_FILENAME = "sweeps.jsonl"
BREAKDOWN_FILENAME = "breakdown.json"

#: default heartbeat cadence in seconds (``PHOTON_OBS_HEARTBEAT_S``)
DEFAULT_HEARTBEAT_S = 2.0
#: default straggler threshold: flagged when a worker's sweep START
#: lags the earliest by more than (X - 1) unobstructed sweeps
DEFAULT_STRAGGLER_X = 2.0
#: heartbeats missed before a worker is *stale*; dead at 3x this
DEFAULT_STALE_X = 3.0

_obs = None  # cached facade module (lazy: obs/__init__ imports this module)


def _facade():
    global _obs
    if _obs is None:
        from photon_tpu_torch import obs

        _obs = obs
    return _obs


# -- knobs ------------------------------------------------------------------


def _float_env(name: str, default: float, minimum: float) -> float:
    env = os.environ.get(name, "").strip()
    if not env:
        return default
    try:
        v = float(env)
    except ValueError as e:
        raise ValueError(f"{name} must be a number, got {env!r}") from e
    if v < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {env!r}")
    return v


def heartbeat_interval_s() -> float:
    """Heartbeat/aggregation cadence (env ``PHOTON_OBS_HEARTBEAT_S``)."""
    return _float_env("PHOTON_OBS_HEARTBEAT_S", DEFAULT_HEARTBEAT_S, 0.05)


def straggler_threshold() -> float:
    """Straggler threshold (``PHOTON_FLEET_STRAGGLER_X``): a worker is
    flagged when its per-sweep ``skew_ratio`` — ``1 + sweep-START
    lateness vs the earliest process, in units of the iteration's
    minimum (unobstructed) sweep wall — exceeds this (default 2.0 =
    started one full unobstructed sweep late)."""
    return _float_env("PHOTON_FLEET_STRAGGLER_X", DEFAULT_STRAGGLER_X, 1.0)


def stale_after_s() -> float:
    """Heartbeat age past which a worker is *stale* (``PHOTON_FLEET_STALE_X``
    heartbeats missed); *dead* at three times this."""
    return _float_env(
        "PHOTON_FLEET_STALE_X", DEFAULT_STALE_X, 1.0
    ) * heartbeat_interval_s()


@dataclass(frozen=True)
class ProcessInfo:
    index: int
    count: int
    host: str
    pid: int


def process_info() -> ProcessInfo:
    """This process's place in the fleet: ``PHOTON_OBS_PROCESS`` (``"i/n"``,
    the test lever and the override for launchers that know better), else
    the live ``torch.distributed`` world when one is initialized with more
    than one rank (read only: finding out never initializes a group, the
    same contract as ``cache.ingest_shard``), else ``(0, 1)``."""
    idx, n = 0, 1
    env = os.environ.get("PHOTON_OBS_PROCESS", "").strip()
    if env:
        idx_s, sep, n_s = env.partition("/")
        try:
            idx, n = int(idx_s), int(n_s)
        except ValueError:
            idx, n = -1, 0
        if not sep or n < 1 or not (0 <= idx < n):
            raise ValueError(
                f"PHOTON_OBS_PROCESS must be 'i/n' with 0 <= i < n, "
                f"got {env!r}"
            )
    else:
        idx, n = live_world()
    return ProcessInfo(
        index=idx, count=n, host=socket.gethostname(), pid=os.getpid()
    )


def live_world() -> tuple[int, int]:
    """``(rank, world size)`` of the initialized ``torch.distributed``
    default group when it has more than one rank, else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def fleet_enabled(info: ProcessInfo | None = None) -> bool:
    """``PHOTON_OBS_FLEET``: ``1`` force on, ``0`` off, unset = auto
    (on exactly when this process is part of a multi-process run)."""
    env = os.environ.get("PHOTON_OBS_FLEET", "").strip()
    if env == "1":
        return True
    if env == "0":
        return False
    if env:
        raise ValueError(
            f"PHOTON_OBS_FLEET must be '0', '1' or unset, got {env!r}"
        )
    return (info or process_info()).count > 1


def obs_dir(out_root, info: ProcessInfo | None = None) -> str:
    """The obs artifact directory for this process under ``out_root``:
    ``<out_root>/obs`` single-process (the historical layout, unchanged
    byte for byte) or ``<out_root>/obs/p<k>`` in a fleet — N workers
    sharing one output root never collide on ``blackbox.ring`` /
    ``series.jsonl`` / exported artifacts again."""
    base = os.path.join(str(out_root), "obs")
    info = info or process_info()
    if not fleet_enabled(info):
        return base
    return os.path.join(base, f"p{info.index}")


def fleet_root_of(directory) -> str:
    """The shared obs root a per-process dir hangs off: ``…/obs/p3`` →
    ``…/obs``; anything else is its own root."""
    d = str(directory)
    base = os.path.basename(os.path.normpath(d))
    if base.startswith("p") and base[1:].isdigit():
        return os.path.dirname(os.path.normpath(d))
    return d


# -- bucket-exact merge -----------------------------------------------------


def empty_histogram() -> dict:
    return {"count": 0, "sum": 0.0, "min": None, "max": None, "buckets": {}}


def merge_histograms(hists: list[dict]) -> dict:
    """Merge sparse log-bucket histogram snapshots BUCKET-EXACT: every
    process bucketed its samples with the same ×1.1 log rule
    (obs/metrics.py), so summing per-bucket counts loses nothing — the
    merged percentiles carry exactly the per-process ±~5% bucket
    resolution, never resolution-on-top-of-resolution. Streaming
    moments sum; min/max take the extremes of the finite ranges;
    non-finite outlier counts add. The empty list merges to the empty
    histogram (identity), pinned in tests."""
    out = empty_histogram()
    for h in hists:
        if not h:
            continue
        out["count"] += int(h.get("count", 0))
        out["sum"] += float(h.get("sum", 0.0))
        nf = int(h.get("nonfinite", 0))
        if nf:
            out["nonfinite"] = out.get("nonfinite", 0) + nf
        for bound in ("min", "max"):
            v = h.get(bound)
            if v is None:
                continue
            cur = out[bound]
            pick = min if bound == "min" else max
            out[bound] = v if cur is None else pick(cur, v)
        for b, c in (h.get("buckets") or {}).items():
            b = str(b)
            out["buckets"][b] = out["buckets"].get(b, 0) + int(c)
    return out


def merge_snapshots(snaps: list[dict]) -> dict:
    """One fleet registry view from per-process ``snapshot()`` dicts:
    counters summed, histograms bucket-exact merged (with fleet
    percentiles recomputed from the merged buckets), gauges OMITTED —
    a last-write-wins scalar has no meaningful cross-process sum; the
    per-process exposition (labeled samples) is where gauges live."""
    from photon_tpu_torch.obs.metrics import (
        SUMMARY_PERCENTILES,
        percentile_from_buckets,
    )

    counters: dict[str, float] = {}
    hist_names: set[str] = set()
    for s in snaps:
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        hist_names.update((s.get("histograms") or {}).keys())
    histograms = {}
    for name in sorted(hist_names):
        merged = merge_histograms(
            [(s.get("histograms") or {}).get(name) or {} for s in snaps]
        )
        for p in SUMMARY_PERCENTILES:
            merged[f"p{p}"] = percentile_from_buckets(merged, p)
        histograms[name] = merged
    return {"counters": counters, "gauges": {}, "histograms": histograms}


# -- per-process heartbeat docs ---------------------------------------------


def read_worker_docs(fleet_root) -> list[dict]:
    """Every per-process heartbeat doc under ``fleet_root``
    (``p*/registry.json``, plus a bare ``registry.json`` for
    single-process publisher runs), unparseable files skipped —
    torn heartbeats must degrade, never crash a scrape."""
    docs = []
    paths = sorted(
        glob.glob(os.path.join(str(fleet_root), "p*", REGISTRY_FILENAME))
    )
    bare = os.path.join(str(fleet_root), REGISTRY_FILENAME)
    if os.path.exists(bare):
        paths.append(bare)
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("unreadable worker heartbeat %s: %s", path, e)
            continue
        if isinstance(doc, dict) and "process_index" in doc:
            doc["_path"] = path
            docs.append(doc)
    docs.sort(key=lambda d: d.get("process_index", 0))
    return docs


def worker_status(doc: Mapping[str, Any], now_wall_s: float) -> str:
    """``ok`` / ``stale`` / ``dead`` from heartbeat age. A clean-stopped
    worker (final heartbeat carries ``stopped``) stays ``ok`` forever —
    finishing first must not read as dying."""
    if doc.get("stopped"):
        return "ok"
    age = now_wall_s - float(doc.get("heartbeat_wall_s", 0.0))
    stale = stale_after_s()
    if age > 3 * stale:
        return "dead"
    if age > stale:
        return "stale"
    return "ok"


def workers_summary(fleet_root, now_wall_s: float | None = None) -> list[dict]:
    """The ``/healthz`` worker table: one row per heartbeat doc with its
    age and ok/stale/dead status."""
    if now_wall_s is None:
        # phl-ok: PHL006 heartbeat ages are wall-clock by definition (cross-process epoch)
        now_wall_s = time.time()
    rows = []
    for doc in read_worker_docs(fleet_root):
        rows.append(
            {
                "process_index": doc.get("process_index"),
                "host": doc.get("host"),
                "pid": doc.get("pid"),
                "seq": doc.get("seq"),
                "stopped": bool(doc.get("stopped")),
                "heartbeat_age_s": round(
                    now_wall_s - float(doc.get("heartbeat_wall_s", 0.0)), 3
                ),
                "status": worker_status(doc, now_wall_s),
            }
        )
    return rows


# -- per-sweep skew ---------------------------------------------------------


#: incremental sweep-log reader state: path -> [consumed byte offset,
#: parsed rows]. The aggregation tick and every /healthz scrape re-read
#: these files; without the cache the per-tick cost grows linearly with
#: fit length (quadratic total I/O over a long fit). Appended-only
#: files re-parse only their NEW bytes; a shrunk file (fresh run over
#: the same directory) resets its entry. Cleared by ``obs.reset()``
#: (via :func:`clear_sweeps_cache`) so a long-lived process running
#: many fits over rotated output dirs doesn't retain every dead run's
#: rows forever. The per-tick COMPUTE over the retained rows is still
#: O(rows) — host-side dict work, acceptable at fit scale; a resident
#: service aggregating for days should raise PHOTON_OBS_HEARTBEAT_S.
_sweeps_cache: dict[str, list] = {}
_sweeps_cache_lock = threading.Lock()


def clear_sweeps_cache() -> None:
    """Drop the incremental sweep-log reader state (run/artifact
    boundary — ``obs.reset()`` calls this)."""
    with _sweeps_cache_lock:
        _sweeps_cache.clear()


def _read_sweep_file(path: str) -> list[dict]:
    try:
        size = os.path.getsize(path)
    except OSError:
        return []
    with _sweeps_cache_lock:
        entry = _sweeps_cache.get(path)
        if entry is None or size < entry[0]:
            entry = _sweeps_cache[path] = [0, []]
        offset, rows = entry
        if size > offset:
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(size - offset)
            except OSError:
                return list(rows)
            # consume only whole lines: a flush mid-write leaves a
            # partial tail that must be re-read NEXT time, not dropped
            end = chunk.rfind(b"\n")
            if end >= 0:
                for line in chunk[: end + 1].splitlines():
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except ValueError:
                        continue
                entry[0] = offset + end + 1
        return list(rows)


def read_sweeps(fleet_root) -> dict[int, list[dict]]:
    """``process_index -> [sweep rows]`` from every ``p*/sweeps.jsonl``
    (and a bare ``sweeps.jsonl``); torn tail lines skipped. Reads are
    incremental (see ``_sweeps_cache``)."""
    out: dict[int, list[dict]] = {}
    paths = sorted(
        glob.glob(os.path.join(str(fleet_root), "p*", SWEEPS_FILENAME))
    )
    bare = os.path.join(str(fleet_root), SWEEPS_FILENAME)
    if os.path.exists(bare):
        paths.append(bare)
    for path in paths:
        for row in _read_sweep_file(path):
            p = int(row.get("process_index", 0))
            out.setdefault(p, []).append(row)
    return out


def compute_skew(
    sweeps_by_proc: Mapping[int, list[dict]],
    straggler_x: float | None = None,
) -> list[dict]:
    """Join per-process sweep rows by iteration into per-sweep skew
    rows. Per iteration each worker's ``skew_ratio`` is ``1 +
    start_lateness / base_sweep_seconds``: how many unobstructed sweeps
    late it STARTED the sweep, where ``base_sweep_seconds`` is the
    iteration's minimum per-process sweep wall (the unobstructed pace —
    the straggler's own wall stays near-healthy while its victims'
    walls inflate waiting in the collectives). A worker whose ratio
    exceeds ``straggler_x`` (``PHOTON_FLEET_STRAGGLER_X``) is a
    straggler.

    Why the START wall and not barrier arrival: under synchronous
    collectives (gloo on CPU — and any backend where dispatch blocks on
    the rendezvous) every process COMPLETES the sweep together, so
    barrier-arrival walls equalize across the fleet; the sweep-start
    wall is the host-observable signal that stays attributable (the
    stalled worker begins late; its victims begin on time and stretch).
    Both walls are recorded; ``skew_s`` reports the arrival spread and
    ``start_skew_s`` the start spread. Cross-host comparability of the
    wall stamps is NTP-grade — attribution, not billing.

    Rows join on ``(run, iteration)`` — iteration numbers restart per
    regularization grid point (the publisher bumps ``run`` on a
    non-increasing iteration) — and each run's first joined iteration
    is reported but NEVER flags stragglers (``warmup``: cross-process
    compile/startup variance legitimately skews it)."""
    if straggler_x is None:
        straggler_x = straggler_threshold()
    # join key is (run, iteration): iteration numbers restart at 0 per
    # regularization grid point, and joining grid-1's sweep 0 against
    # grid-0's would read the whole grid-0 duration as "lateness"
    by_iter: dict[tuple[int, int], dict[int, dict]] = {}
    for p, rows in sweeps_by_proc.items():
        for row in rows:
            if "iteration" not in row or (
                "arrival_wall_s" not in row and "start_wall_s" not in row
            ):
                continue
            key = (int(row.get("run", 0)), int(row["iteration"]))
            by_iter.setdefault(key, {})[p] = row
    #: each run's first joined iteration is WARM-UP: cross-process
    #: one-time and startup variance legitimately skews its start walls
    #: (one worker loads its kernels or builds its layout later than the
    #: other), so it reports skew but never flags stragglers — the same
    #: first-sweep exclusion device_time_breakdown applies
    warmup = {}
    for run, it in by_iter:
        warmup[run] = it if run not in warmup else min(warmup[run], it)
    out = []
    for run, it in sorted(by_iter):
        procs = by_iter[(run, it)]
        arrivals = {
            p: float(r.get("arrival_wall_s", r.get("start_wall_s")))
            for p, r in procs.items()
        }
        starts = {
            p: float(r.get("start_wall_s", r.get("arrival_wall_s")))
            for p, r in procs.items()
        }
        sweep_s = {
            p: float(r.get("sweep_seconds", 0.0)) for p, r in procs.items()
        }
        first_start = min(starts.values())
        base_sweep = max(min(sweep_s.values()), 1e-9)
        ratios = {
            p: 1.0 + (s - first_start) / base_sweep
            for p, s in starts.items()
        }
        is_warmup = it == warmup[run]
        stragglers = (
            []
            if is_warmup
            else sorted(p for p, r in ratios.items() if r > straggler_x)
        )
        out.append(
            {
                "run": run,
                "iteration": it,
                "warmup": is_warmup,
                "processes": len(procs),
                "arrival_wall_s": {str(p): arrivals[p] for p in sorted(arrivals)},
                "start_wall_s": {str(p): starts[p] for p in sorted(starts)},
                "sweep_seconds": {str(p): sweep_s[p] for p in sorted(sweep_s)},
                "barrier_seconds": {
                    str(p): float(procs[p].get("barrier_seconds", 0.0))
                    for p in sorted(procs)
                },
                "base_sweep_s": round(base_sweep, 6),
                "median_sweep_s": round(
                    statistics.median(sweep_s.values()), 6
                ),
                "skew_s": round(
                    max(arrivals.values()) - min(arrivals.values()), 6
                ),
                "start_skew_s": round(
                    max(starts.values()) - first_start, 6
                ),
                "skew_ratio": {
                    str(p): round(ratios[p], 4) for p in sorted(ratios)
                },
                "max_skew_ratio": round(max(ratios.values()), 4),
                "stragglers": stragglers,
            }
        )
    return out


def max_skew_ratio(skew_rows: list[dict]) -> float | None:
    """The headline (and band-gated) skew number: max ``max_skew_ratio``
    over NON-warmup rows. Warm-up rows are excluded for the same reason
    straggler flagging skips them — cross-process compile/startup
    variance legitimately skews a run's first sweep, and a gate reading
    the contaminated max would fail healthy runs the flagging logic
    correctly declines to flag. None when no steady rows exist."""
    vals = [
        r["max_skew_ratio"] for r in skew_rows if not r.get("warmup")
    ]
    return max(vals) if vals else None


# -- the publisher ----------------------------------------------------------


class FleetPublisher:
    """One process's membership in the fleet plane: periodic atomic
    heartbeat snapshots, the per-sweep arrival log, and — on process 0 —
    live aggregation (straggler events + fleet gauges). Threaded like
    the series flusher; every write is guarded (the fleet plane must
    never fail the fit)."""

    def __init__(
        self,
        directory,
        interval_s: float | None = None,
        info: ProcessInfo | None = None,
        registry=None,
    ):
        self.directory = str(directory)
        self.fleet_root = fleet_root_of(directory)
        self.interval_s = (
            heartbeat_interval_s() if interval_s is None else float(interval_s)
        )
        self.info = info or process_info()
        from photon_tpu_torch import obs

        self._registry = registry or obs.get_registry()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._sweeps_file = None
        #: descent-run discriminator: iteration numbers restart at 0 for
        #: every regularization grid point, so rows are keyed (run,
        #: iteration) — a non-increasing iteration bumps the run. Every
        #: process runs the same SPMD schedule, so the counters agree
        #: across the fleet without coordination.
        self._run_idx = 0
        self._last_iteration: int | None = None
        self._seq = 0
        self.heartbeats_written = 0
        self.errors = 0
        #: (iteration, process) straggler events already emitted — the
        #: aggregation loop re-reads the whole sweep log each tick and
        #: must not re-fire old events
        self._flagged: set[tuple[int, int]] = set()

    # -- heartbeat ---------------------------------------------------------

    def write_heartbeat(self, stopped: bool = False) -> dict | None:
        """Atomically rewrite this process's ``registry.json``: tmp
        write + ``os.replace``) so the
        aggregator can never read a torn snapshot."""
        from photon_tpu_torch.obs import flight

        with self._lock:
            doc = {
                "schema": 1,
                "process_index": self.info.index,
                "process_count": self.info.count,
                "host": self.info.host,
                "pid": self.info.pid,
                # phl-ok: PHL006 the heartbeat IS a wall-clock stamp — staleness is judged cross-process
                "heartbeat_wall_s": time.time(),
                "seq": self._seq,
                "stopped": stopped,
                "metrics": self._registry.snapshot(),
                "health": flight.last_health(),
            }
            self._seq += 1
            path = os.path.join(self.directory, REGISTRY_FILENAME)
            tmp = f"{path}.tmp-{self.info.pid}"
            try:
                os.makedirs(self.directory, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(doc, f, default=str)
                os.replace(tmp, path)
            except OSError as e:
                self.errors += 1
                logger.warning("fleet heartbeat write failed: %s", e)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
            self.heartbeats_written += 1
        _facade().counter("fleet.heartbeats")
        return doc

    # -- sweep arrivals ----------------------------------------------------

    def record_sweep(
        self, iteration: int, sweep_seconds: float, barrier_seconds: float
    ) -> None:
        """Append this process's barrier-arrival row for one sweep.
        Called from descent right after its barrier completes, so the
        arrival wall (barrier ENTRY) is now − the measured wait. Pure
        host file I/O: no launch and no read-back."""
        # phl-ok: PHL006 arrival stamps must share a cross-process epoch — wall clock by definition
        now = time.time()
        iteration = int(iteration)
        if (
            self._last_iteration is not None
            and iteration <= self._last_iteration
        ):
            # a new descent run (next grid point / fresh fit in this
            # process): without this, grid-1's iteration-0 row would
            # join against grid-0's across processes mid-transition and
            # fire an unretractable false straggler event
            self._run_idx += 1
        self._last_iteration = iteration
        row = {
            "process_index": self.info.index,
            "run": self._run_idx,
            "iteration": iteration,
            # barrier ENTRY (now − measured wait) and sweep START (now −
            # the whole sweep span): under synchronous collectives
            # (gloo/CPU) every process COMPLETES together — dispatch
            # itself rendezvouses — so arrivals equalize and the START
            # wall is what separates the straggler from its victims
            "arrival_wall_s": round(now - float(barrier_seconds), 6),
            "start_wall_s": round(now - float(sweep_seconds), 6),
            "sweep_seconds": round(float(sweep_seconds), 6),
            "barrier_seconds": round(float(barrier_seconds), 6),
        }
        with self._lock:
            try:
                if self._sweeps_file is None:
                    os.makedirs(self.directory, exist_ok=True)
                    self._sweeps_file = open(
                        os.path.join(self.directory, SWEEPS_FILENAME), "a"
                    )
                self._sweeps_file.write(json.dumps(row) + "\n")
                self._sweeps_file.flush()
            except OSError as e:
                self.errors += 1
                logger.warning("fleet sweep row write failed: %s", e)
                return
        _facade().counter("fleet.sweep_rows")

    # -- process-0 aggregation --------------------------------------------

    def aggregate_once(self) -> list[dict]:
        """One aggregation pass over the shared root (process 0's loop
        runs this each tick; callable directly for tests/report): update
        fleet gauges and emit ``fleet.straggler`` events for NEWLY
        flagged (iteration, process) pairs. Returns the skew rows."""
        obs = _facade()
        try:
            workers = workers_summary(self.fleet_root)
            skew = compute_skew(read_sweeps(self.fleet_root))
        except Exception as e:  # aggregation must never fail the run
            logger.warning("fleet aggregation failed: %s", e)
            return []
        obs.gauge("fleet.workers", len(workers))
        obs.gauge(
            "fleet.stale_workers",
            sum(1 for w in workers if w["status"] != "ok"),
        )
        headline = max_skew_ratio(skew)
        if headline is not None:
            obs.gauge("fleet.skew_ratio_max", headline)
        for row in skew:
            for p in row["stragglers"]:
                key = (row.get("run", 0), row["iteration"], p)
                if key in self._flagged:
                    continue
                self._flagged.add(key)
                obs.counter("fleet.stragglers")
                obs.instant(
                    "fleet.straggler",
                    cat="lifecycle",
                    process_index=p,
                    iteration=row["iteration"],
                    skew_ratio=row["skew_ratio"][str(p)],
                    skew_s=row["start_skew_s"],
                )
                from photon_tpu_torch.obs import flight

                flight.record(
                    "fleet.straggler",
                    process_index=p,
                    iteration=row["iteration"],
                    skew_ratio=row["skew_ratio"][str(p)],
                )
                logger.warning(
                    "fleet straggler: process %d started sweep %d %.3fs "
                    "late (skew ratio %.2f > %.2f)",
                    p, row["iteration"], row["start_skew_s"],
                    row["skew_ratio"][str(p)], straggler_threshold(),
                )
        return skew

    # -- lifecycle ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_heartbeat()
            if self.info.index == 0 and self.info.count > 1:
                self.aggregate_once()

    def start(self) -> "FleetPublisher":
        if self.interval_s <= 0:
            raise ValueError(
                f"FleetPublisher.start() needs interval_s > 0, got "
                f"{self.interval_s!r}"
            )
        if self._thread is not None:
            return self
        self.write_heartbeat()  # visible to the aggregator immediately
        # phl-ok: PHL003 run-scoped publisher thread; stop() below sets the event + joins and every owner (LiveTelemetryPlane / tests) finally-guards stop()
        self._thread = threading.Thread(
            target=self._run, name="obs-fleet-publish", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop, write one FINAL heartbeat stamped ``stopped``
        (a worker that finished must read as done, not dead), close the
        sweep log."""
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                logger.warning(
                    "fleet publisher still blocked after 5 s; detaching"
                )
                return
        if self.info.index == 0 and self.info.count > 1:
            self.aggregate_once()
        self.write_heartbeat(stopped=True)
        with self._lock:
            if self._sweeps_file is not None:
                try:
                    self._sweeps_file.close()
                except OSError:
                    pass
                self._sweeps_file = None


_publisher: FleetPublisher | None = None


def get_publisher() -> FleetPublisher | None:
    return _publisher


def get_fleet_root() -> str | None:
    """The shared obs root of the live publisher (what ``/metrics`` and
    ``/healthz`` aggregate over); None when no publisher is armed."""
    p = _publisher
    return None if p is None else p.fleet_root


def start_publisher(
    directory, interval_s: float | None = None
) -> FleetPublisher | None:
    """Arm the process-global fleet publisher under this process's obs
    dir (None when fleet mode is off or one is already running)."""
    global _publisher
    if _publisher is not None:
        return _publisher
    info = process_info()
    if not fleet_enabled(info):
        return None
    _publisher = FleetPublisher(directory, interval_s, info).start()
    return _publisher


def stop_publisher() -> None:
    global _publisher
    p = _publisher
    _publisher = None
    if p is not None:
        p.stop()


def record_sweep(
    iteration: int, sweep_seconds: float, barrier_seconds: float
) -> None:
    """Descent's per-sweep tap: two module-global reads when no
    publisher is armed (the same zero-overhead discipline as
    ``flight.record`` / ``util.faults``)."""
    p = _publisher
    if p is None:
        return
    p.record_sweep(iteration, sweep_seconds, barrier_seconds)


# -- device-time breakdown --------------------------------------------------


#: the pricing basis of the breakdown's split, an H100 SXM's published
#: figures (NVIDIA data sheet): NVLink 4 at 450 GB/s each way, and 67
#: Tflop/s in float32 outside the tensor cores
DEFAULT_COMM_GBPS = 450.0
DEFAULT_DEVICE_GFLOPS = 67_000.0


def comm_gbps() -> float:
    """Assumed collective payload bandwidth in GB/s for the model-based
    comm-time attribution (``PHOTON_COMM_GBPS``). A pricing basis, not a
    measurement — recorded in every breakdown artifact."""
    return _float_env("PHOTON_COMM_GBPS", DEFAULT_COMM_GBPS, 1e-6)


def device_gflops() -> float:
    """Assumed device compute rate in Gflop/s for the model-based
    compute-time attribution (``PHOTON_DEVICE_GFLOPS``)."""
    return _float_env("PHOTON_DEVICE_GFLOPS", DEFAULT_DEVICE_GFLOPS, 1e-6)


def price_coordinates(coordinates: Mapping[str, Any]) -> dict[str, dict]:
    """Per coordinate with warmed programs: the analytic ``flops`` of one
    evaluation of its warmed sweep program (``Coordinate.program_flops``)
    and, on a mesh, its census's ``comm_bytes`` (one execution per site)
    and ``collective_sites``. A coordinate with no warmed sweep program (an
    unwarmed fit, a locked coordinate) or no flop count (a streaming one)
    is not priced, as JAX prices its AOT sweep executables only."""
    from photon_tpu_torch.analysis.spmd import communication_census

    per_coord: dict[str, dict] = {}
    for cid, coord in coordinates.items():
        programs = getattr(coord, "programs", None)
        warmed = getattr(programs, "warmed", None)
        if not warmed:
            continue
        try:
            flops = coord.program_flops()
        except Exception:
            continue
        sweep = [k for k in warmed if k and k[0] == "sweep" and k in flops]
        if not sweep:
            continue
        mesh = getattr(coord, "mesh", None)
        rows = [r for r in communication_census(getattr(mesh, "census", None) or {})
                if r["coordinate"] == cid]
        per_coord[cid] = {
            "flops": float(sum(flops.get(k, 0.0) for k in sweep)),
            "comm_bytes": sum(r["comm_bytes"] for r in rows),
            "collective_sites": sum(len(r["collective_sites"]) for r in rows),
        }
    return per_coord


def device_time_breakdown(coordinates: Mapping[str, Any], tracker: list) -> dict | None:
    """Join the coordinates' priced programs (:func:`price_coordinates`)
    with the fit's MEASURED per-sweep walls (:func:`breakdown_from_prices`).
    None when there are no sweep rows or no warmed program to price."""
    return breakdown_from_prices(price_coordinates(coordinates), tracker)


def breakdown_from_prices(per_coord: Mapping[str, dict], tracker: list) -> dict | None:
    """The device-time breakdown of priced coordinates (``flops``,
    ``comm_bytes``, ``collective_sites`` each), JAX's join:

    - ``barrier_frac``, measured: mean barrier wait / mean sweep wall over
      the steady sweeps (the first excluded when there are more);
    - per coordinate ``compute_frac`` / ``comm_frac``: the rest of the
      sweep, split across coordinates and between compute and collectives
      in proportion to the cost model (flops at :func:`device_gflops`,
      bytes at :func:`comm_gbps`).

    None when there are no sweep rows or nothing priced."""
    sweep_rows = [r for r in tracker if "sweep_seconds" in r and "coordinate" not in r]
    if not sweep_rows or not per_coord:
        return None
    steady = sweep_rows[1:] or sweep_rows
    sweep_s = sum(r["sweep_seconds"] for r in steady) / len(steady)
    barrier_s = sum(r.get("barrier_seconds", 0.0) for r in steady) / len(steady)
    if sweep_s <= 0:
        return None
    barrier_frac = min(max(barrier_s / sweep_s, 0.0), 1.0)
    per_coord = {cid: dict(d) for cid, d in per_coord.items()}

    # cost-model weights: seconds each coordinate would take at the
    # assumed rates; only their ratios matter for the split
    gf, gb = device_gflops(), comm_gbps()
    weights = {cid: (d["flops"] / (gf * 1e9), d["comm_bytes"] / (gb * 1e9))
               for cid, d in per_coord.items()}
    total_w = sum(wc + wm for wc, wm in weights.values())
    device_frac = 1.0 - barrier_frac
    for cid, d in per_coord.items():
        wc, wm = weights[cid]
        share = (wc + wm) / total_w if total_w > 0 else 1.0 / len(per_coord)
        within_comm = wm / (wc + wm) if (wc + wm) > 0 else 0.0
        d["device_share"] = round(share, 6)
        d["compute_frac"] = round(device_frac * share * (1 - within_comm), 6)
        d["comm_frac"] = round(device_frac * share * within_comm, 6)
    return {
        "sweep_seconds_mean": round(sweep_s, 6),
        "barrier_seconds_mean": round(barrier_s, 6),
        "barrier_frac": round(barrier_frac, 6),
        "compute_frac": round(sum(d["compute_frac"] for d in per_coord.values()), 6),
        "comm_frac": round(sum(d["comm_frac"] for d in per_coord.values()), 6),
        "coordinates": per_coord,
        "provenance": {
            "barrier_frac": "measured (descent barrier span / sweep span)",
            "comm_compute_split": (
                "cost-model attribution: the mesh's collective census bytes (one "
                f"execution per site) at {gb} GB/s vs analytic flops of one evaluation "
                "of each warmed sweep program (fixed effect 2 per nonzero per feature "
                "pass, random effect 2*E*rows*d per solve shape, MF 2*N*k) at "
                f"{gf} Gflop/s, normalized to the measured non-barrier sweep wall"
            ),
            "comm_gbps_assumed": gb,
            "device_gflops_assumed": gf,
            "steady_sweeps": len(steady),
        },
    }


_last_breakdown: dict | None = None


def get_breakdown() -> dict | None:
    """The most recent published device-time breakdown (exporters read
    it; cleared by ``obs.reset()``)."""
    return _last_breakdown


def clear_breakdown() -> None:
    global _last_breakdown
    _last_breakdown = None


def publish_device_breakdown(
    coordinates: Mapping[str, Any], tracker: list
) -> dict | None:
    """Compute :func:`device_time_breakdown` and publish it: ``device.*``
    gauges (per-coordinate ``device.compute_frac.<cid>`` /
    ``device.comm_frac.<cid>``, sweep-level ``device.barrier_frac``),
    retained for the exporters (``breakdown.json`` + the summary
    table). No-op while obs is disabled; never raises."""
    global _last_breakdown
    obs = _facade()
    if not obs.enabled():
        return None
    try:
        bd = device_time_breakdown(coordinates, tracker)
    except Exception as e:  # pricing must never fail the fit
        logger.warning(
            "device-time breakdown failed: %s: %s", type(e).__name__, e
        )
        return None
    if bd is None:
        return None
    _last_breakdown = bd
    obs.gauge("device.barrier_frac", bd["barrier_frac"])
    obs.gauge("device.compute_frac", bd["compute_frac"])
    obs.gauge("device.comm_frac", bd["comm_frac"])
    for cid, d in bd["coordinates"].items():
        obs.gauge(f"device.compute_frac.{cid}", d["compute_frac"])
        obs.gauge(f"device.comm_frac.{cid}", d["comm_frac"])
    return bd


def breakdown_table(bd: Mapping[str, Any] | None = None) -> str:
    """Human-readable per-sweep device-time breakdown table (appended to
    the ``.summary.txt`` exporter)."""
    bd = bd if bd is not None else _last_breakdown
    if not bd:
        return ""
    lines = [
        "device-time breakdown (per steady sweep, "
        f"{bd['sweep_seconds_mean']:.4f}s mean):",
        f"  barrier wait {bd['barrier_frac']:7.1%}  (measured)",
        f"  compute      {bd['compute_frac']:7.1%}  (cost-model split)",
        f"  collectives  {bd['comm_frac']:7.1%}  (cost-model split)",
    ]
    for cid, d in sorted(bd["coordinates"].items()):
        lines.append(
            f"    {cid:<16} compute {d['compute_frac']:7.1%}  comm "
            f"{d['comm_frac']:7.1%}  ({d['collective_sites']} sites, "
            f"{d['comm_bytes']} B, {d['flops']:.3g} flops)"
        )
    return "\n".join(lines)


# -- the offline report -----------------------------------------------------


def fleet_report(fleet_root) -> dict:
    """The full offline fleet document (``python -m photon_tpu_torch.cli.fleet_report``
    prints and writes it): worker table with heartbeat status, the
    merged fleet registry view, per-sweep arrival-skew rows, flagged
    stragglers, and any per-process device-time breakdowns."""
    # phl-ok: PHL006 report generation stamps wall time once (offline path)
    now = time.time()
    docs = read_worker_docs(fleet_root)
    skew = compute_skew(read_sweeps(fleet_root))
    breakdowns = {}
    for path in sorted(
        glob.glob(os.path.join(str(fleet_root), "p*", BREAKDOWN_FILENAME))
        + glob.glob(os.path.join(str(fleet_root), BREAKDOWN_FILENAME))
    ):
        try:
            with open(path) as f:
                bd = json.load(f)
        except (OSError, ValueError):
            continue
        base = os.path.basename(os.path.dirname(path))
        breakdowns[base if base.startswith("p") else "p0"] = bd
    stragglers = [
        {"run": r.get("run", 0), "iteration": r["iteration"],
         "process_index": p,
         "skew_ratio": r["skew_ratio"][str(p)],
         "skew_s": r["start_skew_s"]}
        for r in skew
        for p in r["stragglers"]
    ]
    return {
        "generated_wall_s": now,
        "fleet_root": str(fleet_root),
        "workers": workers_summary(fleet_root, now),
        "straggler_threshold_x": straggler_threshold(),
        "fleet": merge_snapshots(
            [d.get("metrics") or {} for d in docs]
        ),
        "per_process_gauges": {
            str(d.get("process_index")): (d.get("metrics") or {}).get(
                "gauges", {}
            )
            for d in docs
        },
        "health": {
            str(d.get("process_index")): d.get("health") for d in docs
        },
        "skew": skew,
        "max_skew_ratio": max_skew_ratio(skew),
        "stragglers": stragglers,
        "breakdowns": breakdowns,
    }
