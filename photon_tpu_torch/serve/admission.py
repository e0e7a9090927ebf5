"""Bounded admission and typed load shedding for the serving engine.

Counterpart of photon_tpu/serve/admission.py. The streaming scorer's
staging queue bounds host memory; this queue bounds WAITING. A serving
loop that admits everything hides overload in an unbounded backlog, where
latency grows without an error until the process dies. Here admission is
the policy boundary: a bounded queue with per-request deadlines and two
typed shed outcomes:

``AdmissionRejected``
    The queue is at its cap, closed, or the request cannot fit a batch.
    Raised SYNCHRONOUSLY inside :meth:`AdmissionQueue.submit`, so the
    producer learns within its own call that the card cannot make it.
``DeadlineExceeded``
    The request's deadline budget ran out: already at submit, or while
    it waited (the engine sheds it at dequeue instead of spending a
    dispatch on an answer nobody waits for).

Both are load-shed outcomes, not failures of the server:
``game.recovery.classify_failure`` calls them ``load_shed``, which earns
no restart. Every shed bumps ``serve.shed`` and ``serve.shed.<reason>``
(queue_full / deadline / oversize / closed) and, with the tenant known,
``serve.shed.tenant.<tenant>``. The ``serve.admit`` fault point fires
inside ``submit``.

Each request's causal trace (obs/causal.py) is minted at the top of
``submit``, before the fault point, and rides on the request
(``ServeRequest.trace``): the ``serve.admit`` slice and the flow start
are recorded here, a shed closes the trace with ``shed:<reason>`` (an
exemplar), and the engine carries it through the batch. Disarmed, the
mint is the shared null context and records nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time

from photon_tpu_torch import obs
from photon_tpu_torch.game.data import GameData
from photon_tpu_torch.obs import causal
from photon_tpu_torch.util import faults

__all__ = [
    "AdmissionQueue",
    "AdmissionRejected",
    "DeadlineExceeded",
    "ServeFuture",
    "ServeRequest",
    "ServeSheddingError",
    "serve_deadline_s",
    "serve_queue_cap",
]

#: default admission-queue cap (requests waiting, not rows)
DEFAULT_QUEUE_CAP = 64

#: default per-request deadline budget (seconds from arrival)
DEFAULT_DEADLINE_S = 30.0


def serve_queue_cap(config_value: int | None = None) -> int:
    """Admission-queue cap: ``PHOTON_SERVE_QUEUE_CAP`` env > the given
    value > :data:`DEFAULT_QUEUE_CAP`; a bad value raises."""
    env = os.environ.get("PHOTON_SERVE_QUEUE_CAP", "").strip()
    if env:
        v = int(env)
    elif config_value is not None:
        v = int(config_value)
    else:
        return DEFAULT_QUEUE_CAP
    if v < 1:
        raise ValueError(f"serve queue cap must be >= 1, got {v}")
    return v


def serve_deadline_s(config_value: float | None = None) -> float:
    """Default per-request deadline budget: ``PHOTON_SERVE_DEADLINE_S`` env
    > the given value > :data:`DEFAULT_DEADLINE_S`."""
    env = os.environ.get("PHOTON_SERVE_DEADLINE_S", "").strip()
    if env:
        v = float(env)
    elif config_value is not None:
        v = float(config_value)
    else:
        return DEFAULT_DEADLINE_S
    if v <= 0:
        raise ValueError(f"serve deadline must be > 0 seconds, got {v}")
    return v


class ServeSheddingError(RuntimeError):
    """Base class of the two typed load-shed outcomes; never a failure of
    the server (``classify_failure`` → ``load_shed``)."""


class AdmissionRejected(ServeSheddingError):
    """The bounded queue (or the batch geometry) cannot take this request:
    shed at the door, synchronously."""


class DeadlineExceeded(ServeSheddingError):
    """The request's deadline budget ran out before a dispatch could answer
    it: shed instead of served late to nobody."""


class ServeFuture:
    """One request's pending result: scores on success, a typed error on a
    shed or a failure. The producer blocks in :meth:`result`; the engine
    thread resolves it."""

    def __init__(self):
        self._done = threading.Event()
        self._scores = None
        self._exc: BaseException | None = None

    def set_result(self, scores) -> None:
        self._scores = scores
        self._done.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def exception(self) -> BaseException | None:
        return self._exc if self._done.is_set() else None

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError("serve request still pending")
        if self._exc is not None:
            raise self._exc
        return self._scores


@dataclasses.dataclass
class ServeRequest:
    """One admitted request: a chunk of at most ``batch_rows`` rows, its
    arrival (``time.perf_counter`` timebase) and deadline budget."""

    seq: int
    tenant: str
    chunk: GameData
    arrival_t: float
    deadline_s: float
    future: ServeFuture
    #: the request's causal trace (obs/causal.py TraceCtx, or the shared
    #: null context while tracing is disarmed; None for a request built by
    #: hand — every consumer checks)
    trace: object = None

    def expired(self, now: float | None = None) -> bool:
        now = time.perf_counter() if now is None else now
        return (now - self.arrival_t) > self.deadline_s

    def remaining_s(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        return self.deadline_s - (now - self.arrival_t)


def _shed(reason: str, tenant: str | None = None) -> None:
    """The one place a shed is counted: a total, by reason, by tenant."""
    obs.counter("serve.shed")
    obs.counter(f"serve.shed.{reason}")
    if tenant is not None:
        obs.counter(f"serve.shed.tenant.{tenant}")


class AdmissionQueue:
    """The bounded, deadline-aware front door of the serving engine.

    ``submit`` never blocks on a full queue: it sheds. Overload shows up as
    typed rejections inside the caller's own call, and the queue depth
    stays at its cap.
    """

    def __init__(self, *, cap: int | None = None, default_deadline_s: float | None = None,
                 max_rows: int | None = None):
        self.cap = serve_queue_cap(cap)
        self.default_deadline_s = serve_deadline_s(default_deadline_s)
        #: reject-at-door bound on request rows (the engine's batch_rows)
        self.max_rows = max_rows
        self._items: collections.deque[ServeRequest] = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._seq = 0
        #: the local shed census (the obs counters carry the breakdown)
        self.shed_count = 0

    # -- producer side ------------------------------------------------------

    def submit(self, chunk: GameData, *, tenant: str = "default",
               arrival_t: float | None = None, deadline_s: float | None = None) -> ServeFuture:
        """Admit one request, or shed it (typed). ``arrival_t`` is the
        scheduled arrival in the ``perf_counter`` timebase: open-loop load
        sources stamp it so that queueing counts against the deadline."""
        # the chain's first event: the trace is minted before the fault
        # point so an injected admit fault lands inside it
        ctx = causal.mint("serve.request", kind="serve")
        t_admit = time.perf_counter()
        try:
            with ctx.active():
                faults.fault_point("serve.admit")
        except BaseException:
            ctx.finish("fault")
            raise
        now = time.perf_counter()
        arrival = now if arrival_t is None else float(arrival_t)
        budget = self.default_deadline_s if deadline_s is None else float(deadline_s)

        def shed_trace(reason: str) -> None:
            end = time.perf_counter()
            ctx.event("serve.admit", t_admit, end - t_admit, cat="serve", tenant=tenant)
            ctx.instant("serve.shed", reason=reason)
            ctx.finish(f"shed:{reason}", e2e_s=end - arrival)

        if budget <= 0:
            ctx.finish("error")
            raise ValueError(f"deadline budget must be > 0 s, got {budget}")
        if self.max_rows is not None and chunk.num_samples > self.max_rows:
            self.shed_count += 1
            _shed("oversize", tenant)
            shed_trace("oversize")
            raise AdmissionRejected(
                f"request has {chunk.num_samples} rows > the engine's "
                f"batch_rows={self.max_rows}; split it upstream"
            )
        if (now - arrival) > budget:
            # born already dead (a backed-up open-loop producer)
            self.shed_count += 1
            _shed("deadline", tenant)
            shed_trace("deadline")
            raise DeadlineExceeded(
                f"request arrived {now - arrival:.3f}s after its scheduled "
                f"arrival with a {budget:g}s deadline budget"
            )
        with self._lock:
            if self._closed:
                self.shed_count += 1
                _shed("closed", tenant)
                shed_trace("closed")
                raise AdmissionRejected("admission queue is closed")
            if len(self._items) >= self.cap:
                self.shed_count += 1
                _shed("queue_full", tenant)
                shed_trace("queue_full")
                raise AdmissionRejected(
                    f"admission queue at cap ({self.cap} requests waiting); "
                    "the device cannot make this deadline"
                )
            self._seq += 1
            req = ServeRequest(seq=self._seq, tenant=tenant, chunk=chunk, arrival_t=arrival,
                               deadline_s=budget, future=ServeFuture(), trace=ctx)
            self._items.append(req)
            obs.counter("serve.admitted")
            self._not_empty.notify()
        # the admit slice and the flow start the batch fan-in binds to
        # (the flow's stamp inside the slice, on this producer's track)
        ctx.event("serve.admit", t_admit, time.perf_counter() - t_admit, cat="serve",
                  tenant=tenant, seq=req.seq)
        ctx.flow("s", t_admit)
        return req.future

    def close(self) -> None:
        """No further admissions; the engine drains what is queued, then
        exits. Idempotent."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    # -- engine side --------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def _shed_expired(self, req: ServeRequest, now: float, where: str) -> None:
        self.shed_count += 1
        _shed("deadline", req.tenant)
        if req.trace is not None:
            req.trace.instant("serve.shed", reason="deadline",
                              waited_s=round(now - req.arrival_t, 6))
            req.trace.finish("deadline", e2e_s=now - req.arrival_t)
        req.future.set_exception(DeadlineExceeded(
            f"request {req.seq} waited {now - req.arrival_t:.3f}s {where}, past its "
            f"{req.deadline_s:g}s deadline"
        ))

    def next_batch(self, max_rows: int, timeout: float = 0.5) -> list[ServeRequest] | None:
        """Pop one micro-batch: the oldest live request plus every
        same-tenant request behind it that still fits ``max_rows``.
        Requests whose deadline ran out while queued are shed HERE (their
        future resolved with :class:`DeadlineExceeded`). Returns None on a
        timeout with nothing available, and ``[]`` once closed and
        drained (the engine's exit signal)."""
        with self._not_empty:
            while True:
                now = time.perf_counter()
                while self._items and self._items[0].expired(now):
                    self._shed_expired(self._items.popleft(), now, "in the admission queue")
                if self._items:
                    break
                if self._closed:
                    return []
                if not self._not_empty.wait(timeout):
                    return None
            head = self._items.popleft()
            batch = [head]
            rows = head.chunk.num_samples
            keep: list[ServeRequest] = []
            while self._items:
                req = self._items.popleft()
                if req.expired(now):
                    self._shed_expired(req, now, "in the admission queue")
                    continue
                if req.tenant == head.tenant and rows + req.chunk.num_samples <= max_rows:
                    batch.append(req)
                    rows += req.chunk.num_samples
                else:
                    keep.append(req)
            self._items.extendleft(reversed(keep))
            return batch
