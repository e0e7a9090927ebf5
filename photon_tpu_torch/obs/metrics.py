"""Metrics registry: counters, gauges, histograms.

Counterpart of photon_tpu/obs/metrics.py, copied so that the bucket edges
are the same: a snapshot from either package reads the same. One flat
namespace of dotted metric names (``score.batches``, ``serve.shed.deadline``,
``retry.attempts``). Three instrument kinds:

- **counter**: monotonic accumulator (int or float increments);
- **gauge**: last-write-wins scalar;
- **histogram**: streaming count/sum/min/max plus sparse log-spaced bucket
  counts (×1.1 per bucket, no sample buffer), which give p50-p99.9 at
  ~5% relative resolution in O(log range) memory.

``snapshot()`` returns plain JSON-serializable dicts; ``delta()`` diffs two
snapshots' counters.
"""
from __future__ import annotations

import math
import sys
import threading

#: log-bucket growth factor: each bucket spans ×1.1 of value range, so a
#: percentile read is within ~±5% of the true sample value — plenty for
#: latency SLOs, bounded memory for any value range
_BUCKET_BASE = 1.1
_LOG_BASE = math.log(_BUCKET_BASE)

#: percentiles the snapshot (and the .summary.txt exporter) report —
#: p99.9 included since the latency-SLO plane (docs/DESIGN.md
#: §Observability, "Latency SLO taxonomy") gates the deep tail
SUMMARY_PERCENTILES = (50, 90, 99, 99.9)


def _bucket_index(value: float) -> int:
    """Sparse log-bucket index; values ≤ 0 (and -inf) share the floor
    bucket (a latency/bytes histogram never legitimately goes negative)
    and NaN/+inf the ceiling bucket: a diverged run's non-finite health
    sample registers as an outlier instead of raising a ValueError that
    would mask the DivergenceError."""
    if math.isnan(value) or value == math.inf:
        return 10**6
    if value <= 0:  # -inf lands here with the other non-positives
        return -(10**6)
    return math.floor(math.log(value) / _LOG_BASE)


def _bucket_value(index: int) -> float:
    """Representative (geometric-midpoint) value of a bucket. The
    outlier ceiling reports as float max, not inf — snapshots must stay
    strict-JSON serializable (json.dump would emit `Infinity`)."""
    if index == -(10**6):
        return 0.0
    if index == 10**6:
        return sys.float_info.max
    return _BUCKET_BASE ** (index + 0.5)


def percentile_from_buckets(h: dict, q: float) -> float | None:
    """The q-th percentile (0–100) from a histogram's snapshot dict —
    exposed as a function so exporters and offline consumers of
    ``metrics.json`` can summarize without a live registry.

    Within the bucket the target rank lands in, the value interpolates
    log-linearly by rank fraction (midpoint-rank convention: a
    single-sample bucket reads its geometric midpoint, exactly the old
    behavior) instead of snapping to the midpoint — a densely populated
    bucket then resolves its interior, which is what p99.9 needs when
    the tail mass piles into one ×1.1 bucket. Accuracy stays bounded by
    the bucket width (±~5% relative) in the worst case."""
    count = h.get("count", 0)
    buckets = h.get("buckets")
    if not count or not buckets:
        return None
    target = max(1, math.ceil(count * q / 100.0))
    seen = 0
    for idx in sorted(int(k) for k in buckets):
        c = buckets[str(idx)] if str(idx) in buckets else buckets[idx]
        if seen + c >= target:
            if idx in (-(10**6), 10**6):
                v = _bucket_value(idx)  # outlier floors/ceilings don't
            else:  # interpolate — they have no meaningful edges
                frac = min(1.0, max(0.0, (target - seen - 0.5) / c))
                v = _BUCKET_BASE ** (idx + frac)
            # clamp into the observed range: the log interpolation of
            # the extreme buckets can overshoot the true min/max
            # (min/max are None when every sample so far was non-finite)
            lo = h.get("min")
            hi = h.get("max")
            lo = v if lo is None else lo
            hi = v if hi is None else hi
            return min(max(v, lo), hi)
        seen += c
    return h.get("max")


class MetricsRegistry:
    """Thread-safe metrics container."""

    def __init__(self):
        # REENTRANT: the flight recorder's fatal-signal handler calls
        # snapshot() from whatever bytecode boundary the signal landed
        # on — including inside counter()/histogram() on the same
        # thread, where a plain Lock would deadlock the dying process
        # (see the crash handlers of obs/flight.py)
        self._lock = threading.RLock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    # -- instruments -------------------------------------------------------

    def counter(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def histogram(self, name: str, value: float) -> None:
        value = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                # min/max seed from the first FINITE sample (a NaN
                # first sample must not stick as the range forever)
                h = self._hists[name] = {
                    "count": 0,
                    "sum": 0.0,
                    "min": None,
                    "max": None,
                    "buckets": {},
                }
            h["count"] += 1
            if math.isfinite(value):
                h["sum"] += value
                h["min"] = (
                    value if h["min"] is None else min(h["min"], value)
                )
                h["max"] = (
                    value if h["max"] is None else max(h["max"], value)
                )
            else:
                # a non-finite sample counts (it lands in an outlier
                # bucket below) but must not poison the streaming
                # moments for the rest of the run — one NaN would make
                # sum/mean NaN forever and the exported snapshot
                # non-strict JSON
                h["nonfinite"] = h.get("nonfinite", 0) + 1
            # string keys: the snapshot must round-trip through JSON
            # without the int→str key coercion changing its shape
            b = str(_bucket_index(value))
            h["buckets"][b] = h["buckets"].get(b, 0) + 1

    # -- reading -----------------------------------------------------------

    def percentile(self, name: str, q: float) -> float | None:
        """q-th percentile (0–100) of histogram ``name`` from its sparse
        log buckets (±~5% relative resolution); None when unobserved."""
        with self._lock:
            h = self._hists.get(name)
            h = None if h is None else dict(h, buckets=dict(h["buckets"]))
        return None if h is None else percentile_from_buckets(h, q)

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}`` —
        plain data, safe to json.dumps. Histogram entries carry their
        streaming moments, the sparse buckets, and pNN summaries."""
        with self._lock:
            hists = {
                k: dict(v, buckets=dict(v["buckets"]))
                for k, v in self._hists.items()
            }
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": hists,
            }
        for h in out["histograms"].values():
            for p in SUMMARY_PERCENTILES:
                h[f"p{p}"] = percentile_from_buckets(h, p)
        return out

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Counter-wise ``after − before`` (gauges/histograms report the
        ``after`` state: they are not monotonic)."""
        b = before.get("counters", {})
        a = after.get("counters", {})
        return {
            "counters": {
                k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)
            },
            "gauges": dict(after.get("gauges", {})),
            "histograms": {
                k: dict(v) for k, v in after.get("histograms", {}).items()
            },
        }
