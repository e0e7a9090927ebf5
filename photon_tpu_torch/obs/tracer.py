"""Thread-safe span tracer whose spans line up with device traces.

Counterpart of photon_tpu/obs/tracer.py. A :class:`Span` is one named,
timed region on one thread. Spans nest per thread: a span started while
another is open on the same thread records it as its parent; spans of
other threads stay independent, and Perfetto draws each thread as a track.

Clocks: ``time.perf_counter_ns`` for timing, with one ``time.time()``
anchor taken when the tracer is built, so exporters can place the
monotonic timeline in wall-clock time.

Where JAX enters a ``jax.profiler.TraceAnnotation`` per recorded span, the
port enters ``torch.profiler.record_function`` with the span's name: under
a ``torch.profiler`` trace the host span then appears as a
``user_annotation`` range that the device work it launched lines up with.
The range carries the name only: torch's exported trace drops a
``record_function`` argument string (checked on torch 2.11 with CUDA 12.8
and on 2.13 for the CPU), and the profiler's clock is not
``perf_counter_ns``. So the join goes the other way:
``export.join_device_trace`` matches each range to its span record, in
order per (name, thread), takes the clocks' offset from the matches and
gives the range the record's args, id and causal ``trace_id``; records
carry the OS thread id (``native_tid``) that the profiler names threads
by. A DISABLED tracer's span still measures its wall (two clock reads)
but takes no lock, records nothing and enters no annotation; no mode of
the tracer launches device work or synchronizes.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from photon_tpu_torch.obs import causal


@dataclass
class SpanRecord:
    """One finished span, as recorded by the tracer."""

    name: str
    cat: str
    t0_ns: int  # perf_counter_ns at entry
    dur_ns: int  # 0 for instant events
    tid: int
    span_id: int
    parent_id: int | None
    args: dict[str, Any] = field(default_factory=dict)
    instant: bool = False
    #: the OS thread id (``threading.get_native_id``), as a profiler
    #: trace names the thread; 0 where unknown
    native_tid: int = 0
    #: the causal trace (obs/causal.py) active on the thread at entry
    trace_id: int | None = None


class Span:
    """Context manager for one traced region.

    ``with tracer.span("fit") as sp: ... sp.set(grid=3)``: attributes set
    during the span land in the exported event's ``args``. After exit,
    ``duration_s`` holds the measured wall whether or not the span was
    recorded.
    """

    __slots__ = (
        "_tracer", "name", "cat", "args", "_t0_ns", "_dur_ns", "_recording", "_ann",
        "_parent_id", "span_id", "_trace_id",
    )

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0_ns = 0
        self._dur_ns = 0
        self._recording = False
        self._ann = None
        self._parent_id = None
        self.span_id = 0
        self._trace_id = None

    def set(self, **kwargs) -> "Span":
        """Attach attributes (exported as trace-event ``args``)."""
        self.args.update(kwargs)
        return self

    @property
    def duration_s(self) -> float:
        return self._dur_ns / 1e9

    def __enter__(self) -> "Span":
        tracer = self._tracer
        # latched at entry: a mid-span toggle cannot half-record a span
        self._recording = tracer.enabled
        if self._recording:
            self.span_id = next(tracer._ids)
            stack = tracer._stack()
            self._parent_id = stack[-1] if stack else None
            stack.append(self.span_id)
            self._trace_id = causal.current_trace_id()
            if tracer.annotate_device:
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._dur_ns = time.perf_counter_ns() - self._t0_ns
        if not self._recording:
            return
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        tracer._record(
            SpanRecord(
                name=self.name, cat=self.cat, t0_ns=self._t0_ns, dur_ns=self._dur_ns,
                tid=threading.get_ident(), span_id=self.span_id,
                parent_id=self._parent_id, args=self.args,
                native_tid=threading.get_native_id(), trace_id=self._trace_id,
            )
        )


class Tracer:
    """Collects :class:`SpanRecord`s from every thread of the process."""

    def __init__(self, enabled: bool = True, annotate_device: bool = True):
        self.enabled = enabled
        self.annotate_device = annotate_device
        self._lock = threading.Lock()
        self._spans: list[SpanRecord] = []
        self._ids = itertools.count(1)
        self._tls = threading.local()
        # the one wall-clock capture; spans step from the monotonic base
        # phl-ok: PHL006 epoch anchor: the one wall capture; spans step from the monotonic base
        self.epoch_wall_s = time.time()
        self.epoch_ns = time.perf_counter_ns()
        self.pid = os.getpid()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)

    def span(self, name: str, cat: str = "phase", **args) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        if not self.enabled:
            return
        stack = self._stack()
        self._record(
            SpanRecord(
                name=name, cat=cat, t0_ns=time.perf_counter_ns(), dur_ns=0,
                tid=threading.get_ident(), span_id=next(self._ids),
                parent_id=stack[-1] if stack else None, args=args, instant=True,
            )
        )

    def spans(self) -> list[SpanRecord]:
        """A copy of every recorded span (safe to iterate while other
        threads keep recording)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._tls = threading.local()
