"""Latency SLO plane: declarative specs, burn rates, stage attribution.

Counterpart of photon_tpu/obs/slo.py, copied so that a spec parses and
renders the same and a tracker fed the same latencies reports the same.

- :class:`SloSpec`: a latency objective (percentile, budget, evaluation
  window) in the compact form ``p99<=50ms@60s`` (env ``PHOTON_SLO_SPEC``).
- :class:`SloTracker`: the live evaluator. ``GameScorer.stream`` and the
  serving engine call :func:`observe_batch` per batch or request; a
  violation is counted under its **dominant stage** (the pipeline stage
  that took the most of the wall) and feeds multi-window **burn rates**
  (violating fraction over the error budget, for the spec window and its
  /6 and /36 sub-windows).
- :func:`report`: the ``slo_report.json`` document (spec, violation
  census, burn rates, the per-stage p50/p90/p99/p99.9 waterfall from the
  ``score.stage_seconds.*`` or ``serve.stage_seconds.*`` histograms).
- :func:`check_slo` / :func:`main`: the offline gate, ``python -m
  photon_tpu_torch.obs.slo slo_report.json``: exit 0 healthy, 3 when the
  objective percentile breaches its budget or a burn window exceeds
  ``--max-burn``. ``--series`` re-derives windowed burn rates from the
  ``series.jsonl`` counter deltas.

End-to-end latency is measured from a batch's birth: the scheduled
arrival when the load source stamps one (``slo_arrival_t`` on a chunk,
the request's arrival in the serving engine), else the start of its
decode. Queueing therefore counts against the budget.

Counters (through :func:`photon_tpu_torch.obs.counter`, so disabled
telemetry costs nothing): ``slo.batches``, ``slo.violations``,
``slo.violations.<stage>``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import threading
import time
from collections import deque

__all__ = [
    "SloSpec",
    "SloTracker",
    "active",
    "burn_rates_from_series",
    "check_slo",
    "clear",
    "ensure_from_env",
    "install",
    "observe_batch",
    "report",
    "reportable",
    "reset_run_state",
    "spec_from_env",
]

_ENV_SPEC = "PHOTON_SLO_SPEC"
_ENV_MAX_BURN = "PHOTON_SLO_GATE_BURN"

#: burn-rate windows as divisors of the spec's evaluation window — the
#: SRE fast/slow-burn ladder (window, window/6, window/36), each floored
#: at 1 s so a short spec window still yields distinct rungs
BURN_WINDOW_DIVISORS = (1, 6, 36)

#: the pipeline stages a batch lifecycle attributes its wall to, in
#: pipeline order (game/scoring.py measures each per batch;
#: ``pipeline`` is the double-buffer hold — batch i's read-back waits
#: for batch i+1's enqueue, real latency from batch i's perspective)
STAGES = (
    "queue", "decode", "assemble", "h2d", "dispatch", "pipeline",
    "readback", "write",
)

#: the waterfall/report percentiles (p99.9 included — the tail the SLO
#: objective usually lives at)
REPORT_PERCENTILES = (50, 90, 99, 99.9)

_SPEC_RE = re.compile(
    r"^p(?P<pct>\d+(?:\.\d+)?)\s*<=\s*(?P<budget>\d+(?:\.\d+)?)\s*"
    r"(?P<unit>ms|s)\s*@\s*(?P<window>\d+(?:\.\d+)?)\s*s$"
)


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """A declarative latency objective: "the ``percentile``-th percentile
    of end-to-end batch latency stays ≤ ``budget_s`` over any
    ``window_s`` evaluation window"."""

    percentile: float
    budget_s: float
    window_s: float

    def __post_init__(self):
        if not 0.0 < self.percentile < 100.0:
            raise ValueError(
                f"SLO percentile must be in (0, 100), got {self.percentile}"
            )
        if self.budget_s <= 0:
            raise ValueError(f"SLO budget must be > 0s, got {self.budget_s}")
        if self.window_s <= 0:
            raise ValueError(f"SLO window must be > 0s, got {self.window_s}")

    @property
    def error_budget(self) -> float:
        """The allowed violating fraction: p99 ≤ budget tolerates 1% of
        batches over it."""
        return 1.0 - self.percentile / 100.0

    def burn_windows_s(self) -> tuple[float, ...]:
        return tuple(
            max(1.0, self.window_s / d) for d in BURN_WINDOW_DIVISORS
        )

    def render(self) -> str:
        pct = f"{self.percentile:g}"
        if self.budget_s < 1.0:
            budget = f"{self.budget_s * 1000.0:g}ms"
        else:
            budget = f"{self.budget_s:g}s"
        return f"p{pct}<={budget}@{self.window_s:g}s"

    @classmethod
    def parse(cls, spec: str) -> "SloSpec":
        """Parse the compact declarative form, e.g. ``p99<=50ms@60s`` or
        ``p99.9<=0.2s@120s``."""
        m = _SPEC_RE.match(spec.strip())
        if not m:
            raise ValueError(
                f"bad SLO spec {spec!r}: expected "
                "p<percentile><=<budget><ms|s>@<window>s "
                "(e.g. p99<=50ms@60s)"
            )
        budget = float(m.group("budget"))
        if m.group("unit") == "ms":
            budget /= 1000.0
        return cls(
            percentile=float(m.group("pct")),
            budget_s=budget,
            window_s=float(m.group("window")),
        )

    def as_dict(self) -> dict:
        return {
            "spec": self.render(),
            "percentile": self.percentile,
            "budget_s": self.budget_s,
            "window_s": self.window_s,
            "error_budget": self.error_budget,
        }


def spec_from_env() -> SloSpec | None:
    """The spec ``PHOTON_SLO_SPEC`` declares (None when unset/empty);
    a malformed value raises loudly — the repo's knob convention."""
    raw = os.environ.get(_ENV_SPEC, "").strip()
    return SloSpec.parse(raw) if raw else None


def gate_max_burn(cli_value: float | None = None) -> float:
    """Max allowed burn rate for the gate: ``PHOTON_SLO_GATE_BURN`` env >
    explicit value > 1.0 (consuming error budget exactly as fast as the
    spec allows)."""
    env = os.environ.get(_ENV_MAX_BURN, "").strip()
    if env:
        v = float(env)
    elif cli_value is not None:
        v = float(cli_value)
    else:
        return 1.0
    if v <= 0:
        raise ValueError(f"max burn rate must be > 0, got {v}")
    return v


class SloTracker:
    """Live SLO state for one armed spec: violation census by dominant
    stage plus a bounded event window for burn rates. Thread-safe (the
    scorer's consumer thread feeds it; the HTTP endpoint reads it)."""

    #: burn-rate events retained (monotonic_t, violated) — bounds memory
    #: at sustained QPS; 64k events cover any realistic spec window
    MAX_EVENTS = 1 << 16

    def __init__(self, spec: SloSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self.batches = 0
        self.violations = 0
        self.by_stage: dict[str, int] = {}
        self._events: deque = deque(maxlen=self.MAX_EVENTS)
        # the fastest burn window, tracked incrementally so "is the burn
        # window hot right now" costs no rescan of the event deque
        self._fast_window_s = min(spec.burn_windows_s())
        self._fast: deque = deque()
        self._fast_violations = 0

    def _prune_fast_locked(self, now: float) -> None:
        cutoff = now - self._fast_window_s
        fast = self._fast
        while fast and fast[0][0] < cutoff:
            _, violated = fast.popleft()
            if violated:
                self._fast_violations -= 1

    def observe(self, e2e_s: float, stages: dict | None) -> str | None:
        """Record one finished batch; returns the dominant stage name
        when the batch blew its budget (None when within budget)."""
        violated = not (e2e_s <= self.spec.budget_s) or not math.isfinite(
            e2e_s
        )
        dominant = None
        if violated:
            dominant = dominant_stage(stages) or "unattributed"
        now = time.perf_counter()
        with self._lock:
            self.batches += 1
            self._events.append((now, violated))
            self._fast.append((now, violated))
            if violated:
                self.violations += 1
                self._fast_violations += 1
                self.by_stage[dominant] = self.by_stage.get(dominant, 0) + 1
            self._prune_fast_locked(now)
        return dominant

    def fast_burning(self, now: float | None = None) -> bool:
        """True when the FASTEST burn window is consuming error budget
        faster than the spec tolerates (rate > 1)."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            self._prune_fast_locked(now)
            n = len(self._fast)
            if not n:
                return False
            rate = (self._fast_violations / n) / self.spec.error_budget
        return rate > 1.0

    def burn_rates(self, now: float | None = None) -> dict:
        """Per-window burn rates: ``violating fraction / error budget``
        over each trailing window (1.0 = consuming error budget exactly
        as fast as the spec tolerates; >1 = on track to breach). Rate is
        None for a window that saw no batches."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            events = list(self._events)
        out = {}
        for w in self.spec.burn_windows_s():
            cutoff = now - w
            batches = violations = 0
            for t, violated in reversed(events):
                if t < cutoff:
                    break
                batches += 1
                violations += violated
            rate = None
            if batches:
                rate = (violations / batches) / self.spec.error_budget
            out[f"{w:g}s"] = {
                "window_s": w,
                "batches": batches,
                "violations": violations,
                "rate": None if rate is None else round(rate, 4),
            }
        return out

    def reset_run_state(self) -> None:
        """Zero the per-run census (the spec stays armed) — the artifact
        boundary ``obs.reset()`` applies to the whole pipeline."""
        with self._lock:
            self.batches = 0
            self.violations = 0
            self.by_stage.clear()
            self._events.clear()
            self._fast.clear()
            self._fast_violations = 0


def dominant_stage(stages: dict | None) -> str | None:
    """The stage that consumed the most wall in one batch's lifecycle."""
    if not stages:
        return None
    finite = {k: v for k, v in stages.items() if math.isfinite(v)}
    if not finite:
        return None
    return max(finite, key=lambda k: finite[k])


#: the armed tracker — None is THE disarmed state observe_batch checks
_TRACKER: SloTracker | None = None


def active() -> SloTracker | None:
    return _TRACKER


def install(spec: SloSpec | str) -> SloTracker:
    """Arm an SLO (replacing any armed one) and return its tracker."""
    global _TRACKER
    if isinstance(spec, str):
        spec = SloSpec.parse(spec)
    _TRACKER = SloTracker(spec)
    return _TRACKER


def clear() -> None:
    """Disarm the SLO plane entirely (spec and census both dropped)."""
    global _TRACKER
    _TRACKER = None


def ensure_from_env() -> SloTracker | None:
    """Arm from ``PHOTON_SLO_SPEC`` unless a tracker is already armed
    (programmatic :func:`install` wins) — the streaming scorer calls
    this once per stream so driver runs need no code change."""
    if _TRACKER is not None:
        return _TRACKER
    spec = spec_from_env()
    return install(spec) if spec is not None else None


def reset_run_state() -> None:
    """Per-run reset hook for ``obs.reset()``: census zeroed, spec kept."""
    if _TRACKER is not None:
        _TRACKER.reset_run_state()


def observe_batch(e2e_s: float, stages: dict | None = None) -> str | None:
    """Feed one finished batch to the armed SLO (no-op when disarmed).
    Emits ``slo.*`` counters through the gated obs pipeline and returns
    the dominant stage when the batch violated its deadline."""
    from photon_tpu_torch import obs

    t = _TRACKER
    if t is None:
        return None
    dominant = t.observe(e2e_s, stages)
    obs.counter("slo.batches")
    if dominant is not None:
        obs.counter("slo.violations")
        obs.counter(f"slo.violations.{dominant}")
        obs.instant(
            "slo.violation",
            cat="lifecycle",
            e2e_s=round(e2e_s, 6),
            budget_s=t.spec.budget_s,
            dominant_stage=dominant,
        )
    return dominant


# -- the report + gate ------------------------------------------------------


def _hist_percentiles(h: dict) -> dict:
    from photon_tpu_torch.obs.metrics import percentile_from_buckets

    out = {"count": h.get("count", 0)}
    for p in REPORT_PERCENTILES:
        out[f"p{p:g}"] = percentile_from_buckets(h, p)
    return out


def report(registry=None) -> dict:
    """The ``slo_report.json`` document: spec + violation census + burn
    rates from the live tracker, and the per-stage latency waterfall
    (p50/p90/p99/p99.9 per stage + end-to-end) from the registry's
    sparse log-bucket histograms. Always returns a dict — ``armed`` /
    ``observed`` say whether there is anything behind it (the ``/slo``
    endpoint serves it unconditionally; exporters write it only when
    :func:`reportable`)."""
    from photon_tpu_torch import obs

    # a scrape/export reflects the DECLARED objective even before the
    # first stream armed it — idempotent, env-driven, loud on bad specs
    ensure_from_env()
    reg = registry if registry is not None else obs.get_registry()
    snap = reg.snapshot()
    hists = snap.get("histograms", {})
    counters = snap.get("counters", {})
    waterfall = {}
    # the serving engine records the same lifecycle stages under its own
    # ``serve.*`` names; a process runs one plane or the other, and the
    # batch-scoring names win on the (never expected) overlap
    for prefix in ("serve.stage_seconds.", "score.stage_seconds."):
        for name in sorted(hists):
            if name.startswith(prefix):
                waterfall[name[len(prefix):]] = _hist_percentiles(
                    hists[name]
                )
    e2e_hist_name = "score.e2e_seconds"
    if not hists.get(e2e_hist_name, {}) and hists.get(
        "serve.e2e_seconds", {}
    ):
        e2e_hist_name = "serve.e2e_seconds"
    e2e = _hist_percentiles(hists.get(e2e_hist_name, {}))
    t = _TRACKER
    doc: dict = {
        "armed": t is not None,
        "observed": bool(e2e["count"]),
        "spec": None if t is None else t.spec.as_dict(),
        "batches": 0 if t is None else t.batches,
        "violations": 0 if t is None else t.violations,
        "violations_by_stage": {} if t is None else dict(t.by_stage),
        "dominant_stage": None if t is None else dominant_stage(t.by_stage),
        "burn_rates": {} if t is None else t.burn_rates(),
        "e2e": e2e,
        "waterfall": waterfall,
        "counters": {
            k: v
            for k, v in sorted(counters.items())
            # the serving engine's shed/admission censuses belong next
            # to the burn rates they explain
            if k.startswith(("slo.", "serve."))
        },
    }
    if t is not None and e2e["count"]:
        from photon_tpu_torch.obs.metrics import percentile_from_buckets

        observed = percentile_from_buckets(
            hists[e2e_hist_name], t.spec.percentile
        )
        doc["objective"] = {
            "percentile": t.spec.percentile,
            "observed_s": observed,
            "budget_s": t.spec.budget_s,
            "ok": observed is not None and observed <= t.spec.budget_s,
        }
    return doc


def reportable(doc: dict) -> bool:
    """Whether a report document carries any SLO substance worth an
    artifact (an armed spec, or observed batch-latency histograms)."""
    return bool(doc.get("armed") or doc.get("observed"))


def burn_rates_from_series(rows: list[dict], spec: SloSpec) -> dict:
    """Windowed burn rates re-derived OFFLINE from series rows
    (counter DELTAS per flush interval): for each burn window, the
    violating fraction over the trailing rows whose intervals fit the
    window, ÷ the error budget. The gate's trajectory view of a
    finished run — no live tracker needed."""
    out = {}
    for w in spec.burn_windows_s():
        covered = 0.0
        batches = violations = 0
        for row in reversed(rows):
            if covered >= w:
                break
            counters = row.get("counters", {})
            batches += counters.get("slo.batches", 0)
            violations += counters.get("slo.violations", 0)
            covered += row.get("interval_s", 0.0)
        rate = None
        if batches:
            rate = (violations / batches) / spec.error_budget
        out[f"{w:g}s"] = {
            "window_s": w,
            "batches": batches,
            "violations": violations,
            "rate": None if rate is None else round(rate, 4),
        }
    return out


def check_slo(
    doc: dict,
    max_burn: float = 1.0,
    series_rows: list[dict] | None = None,
) -> list[str]:
    """Gate violations for one SLO report document (empty list =
    healthy). Checks, in order of directness:

    1. the OBJECTIVE: the spec percentile of observed end-to-end
       latency vs the budget (from the report's histogram read);
    2. live burn windows over ``max_burn``;
    3. ``--series`` burn windows (re-derived from series rows) over
       ``max_burn``.

    Every failure that can name the dominant stage does."""
    out: list[str] = []
    spec_d = doc.get("spec")
    if not doc.get("armed") or not spec_d:
        out.append(
            "no SLO spec armed (set PHOTON_SLO_SPEC or slo.install()) — "
            "nothing to gate is a gate failure, not a pass"
        )
        return out
    dominant = doc.get("dominant_stage")
    suffix = f" (dominant stage: {dominant})" if dominant else ""
    obj = doc.get("objective")
    if obj is not None and not obj.get("ok"):
        out.append(
            f"p{spec_d['percentile']:g} end-to-end latency "
            f"{obj.get('observed_s')} s > budget {spec_d['budget_s']} s"
            f"{suffix}"
        )
    for label, b in (doc.get("burn_rates") or {}).items():
        rate = b.get("rate")
        if rate is not None and rate > max_burn:
            out.append(
                f"burn rate {rate} > {max_burn} over the {label} window "
                f"({b['violations']}/{b['batches']} batches violating)"
                f"{suffix}"
            )
    if series_rows:
        spec = SloSpec(
            percentile=spec_d["percentile"],
            budget_s=spec_d["budget_s"],
            window_s=spec_d["window_s"],
        )
        for label, b in burn_rates_from_series(series_rows, spec).items():
            rate = b.get("rate")
            if rate is not None and rate > max_burn:
                out.append(
                    f"series burn rate {rate} > {max_burn} over the "
                    f"{label} window ({b['violations']}/{b['batches']} "
                    f"batches violating){suffix}"
                )
    return out


def main(argv=None) -> int:
    """CLI gate: ``python -m photon_tpu_torch.obs.slo slo_report.json``.
    Exit codes: 0 healthy, 3 = the
    report breaches its SLO (or is unreadable/disarmed)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.obs.slo", description=__doc__
    )
    ap.add_argument("report", help="path to an exported slo_report.json")
    ap.add_argument(
        "--max-burn",
        type=float,
        default=None,
        help="max allowed burn rate per window (default 1.0; env "
        f"{_ENV_MAX_BURN} wins)",
    )
    ap.add_argument(
        "--series",
        default=None,
        metavar="PATH",
        help="a series.jsonl trajectory to re-derive windowed burn "
        "rates from the flusher rows",
    )
    args = ap.parse_args(argv)
    try:
        with open(args.report) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"SLO REPORT UNREADABLE: {e}")
        return 3
    if isinstance(doc.get("slo"), dict):
        # the exporter wraps the document under "slo" next to run meta
        doc = doc["slo"]
    rows = None
    if args.series:
        from photon_tpu_torch.obs.series import read_series

        rows = read_series(args.series)
    violations = check_slo(
        doc, max_burn=gate_max_burn(args.max_burn), series_rows=rows
    )
    spec_d = doc.get("spec") or {}
    print(
        f"SLO {spec_d.get('spec', '(none)')}: "
        f"{doc.get('violations', 0)}/{doc.get('batches', 0)} batches "
        f"violating"
    )
    for label, b in (doc.get("burn_rates") or {}).items():
        print(f"  burn[{label}] = {b.get('rate')}")
    if violations:
        for v in violations:
            print(f"[FAIL] {v}")
        return 3
    print("[ok] SLO healthy")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
