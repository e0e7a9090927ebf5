"""Deterministic fault injection: named fault points and a fault plan.

Counterpart of photon_tpu/util/faults.py. Every recovery path of the
port (checkpoint and resume, supervised restarts, the divergence
policies) is exercised by a DETERMINISTIC fault: the same plan gives the
same failure at the same place in every run, so a test can hold the
recovered model bit for bit against the run with no fault.

Fault points
------------
A fault point is one named call at an existing choke point::

    from photon_tpu_torch.util import faults
    faults.fault_point("descent.sweep")

With no plan installed it is two reads of a module global. With a plan,
each call counts that point's arrivals (thread-safe) and fires the
planned fault when ``(point, occurrence)`` matches.

Fault points of the port: ``descent.sweep`` (start of each sweep),
``descent.coordinate`` (before each coordinate step; ``nan`` poisons the
coordinate's state on its device), ``checkpoint.write`` (before a
snapshot is written) and ``checkpoint.replace`` (after a snapshot's
temporary file is written, before its rename); the I/O points
``io.decode`` (each Avro read, inside its retry), ``io.native_decode``
(each file of the native decode, which then falls back to the record
decoder) and ``io.shard_flush`` (each score part file, inside its retry);
the streaming scorer's ``scoring.producer`` (the producer thread's start,
outside its error hand-off), ``scoring.chunk`` (each chunk pull, inside
it) and ``scoring.batch`` (each batch attempt, inside its retry); and the
feature cache's ``cache.open``, ``cache.read`` (each replayed chunk),
``cache.write`` (each appended chunk) and ``cache.replace`` (the publish
window between moving the old cache aside and renaming the new one in).

Fault plan
----------
``PHOTON_FAULTS`` (env) or :func:`install` take a spec of
semicolon-separated clauses::

    <point>@<occurrence>=<kind>[:<param>]

``occurrence`` is the 1-based count of times the point fires (``*``
matches every occurrence). Kinds:

``unavailable``   raise :class:`InjectedFault` whose message carries the
                  transient ``UNAVAILABLE`` marker, which the restart
                  classifiers treat as transient.
``io_error``      raise :class:`InjectedIOError` (an ``OSError``).
``error``         raise :class:`InjectedFault` with NO transient marker:
                  a fatal failure that must not be retried.
``nan``           no raise: the site poisons its value.
``stall[:sec]``   ``time.sleep(sec)`` (default 5).
``crash``         raise :class:`InjectedCrash` (a ``BaseException``):
                  abrupt death for in-process tests, which no
                  ``except Exception`` cleanup may see.
``kill``          ``SIGKILL`` the process.

Occurrence counting is the determinism anchor: the program's control
flow is deterministic, so the N-th arrival at a point is the same
arrival in every run. A restart in the SAME process keeps counting (a
one-shot clause that fired does not fire again on the resumed attempt);
a relaunched process starts from zero, so a relaunch clears
``PHOTON_FAULTS`` for its recovery run.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from contextlib import contextmanager
from typing import Iterator

__all__ = [
    "FaultClause",
    "FaultPlan",
    "InjectedCrash",
    "InjectedFault",
    "InjectedIOError",
    "active",
    "clear",
    "fault_point",
    "install",
    "install_from_env",
    "injected",
    "parse_plan",
]

logger = logging.getLogger(__name__)

_ENV = "PHOTON_FAULTS"
_KINDS = (
    "unavailable", "io_error", "error", "nan", "stall", "crash", "kill",
)


class InjectedFault(RuntimeError):
    """A planned fault (kinds ``unavailable`` / ``error``). The
    ``unavailable`` kind embeds the transient marker in its message so
    the classifiers (util/retry.is_transient) treat it as transient."""


class InjectedIOError(OSError):
    """A planned I/O fault (kind ``io_error``)."""


class InjectedCrash(BaseException):
    """Simulated abrupt process death (kind ``crash``). Deliberately a
    ``BaseException``: no ``except Exception`` recovery/cleanup handler
    may see it — only what is on disk survives, as after a real death."""


@dataclasses.dataclass(frozen=True)
class FaultClause:
    point: str
    occurrence: int | None  # None = every occurrence ("*")
    kind: str
    param: str | None = None

    def render(self) -> str:
        occ = "*" if self.occurrence is None else str(self.occurrence)
        suffix = f":{self.param}" if self.param is not None else ""
        return f"{self.point}@{occ}={self.kind}{suffix}"


class FaultPlan:
    """A parsed fault plan plus its occurrence counters."""

    def __init__(self, clauses: tuple[FaultClause, ...]):
        self.clauses = clauses
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._points = {c.point for c in clauses}

    def match(self, point: str) -> FaultClause | None:
        """Count this arrival at ``point`` and return the clause it
        triggers, if any. Points the plan never names skip the counter
        entirely (and the lock with it)."""
        if point not in self._points:
            return None
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
        for c in self.clauses:
            if c.point == point and (c.occurrence is None or c.occurrence == n):
                return c
        return None

    def render(self) -> str:
        return ";".join(c.render() for c in self.clauses)


def parse_plan(spec: str) -> FaultPlan:
    """Parse a ``point@occurrence=kind[:param]`` spec (see module doc)."""
    clauses = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, sep, action = raw.partition("=")
        if not sep:
            raise ValueError(
                f"bad fault clause {raw!r}: expected "
                "<point>@<occurrence>=<kind>[:<param>]"
            )
        point, sep, occ = head.partition("@")
        point = point.strip()
        occ = occ.strip()
        if not sep or not point or not occ:
            raise ValueError(
                f"bad fault clause {raw!r}: missing point@occurrence"
            )
        if occ == "*":
            occurrence = None
        else:
            occurrence = int(occ)
            if occurrence < 1:
                raise ValueError(
                    f"bad fault clause {raw!r}: occurrence is 1-based"
                )
        kind, _, param = action.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"bad fault clause {raw!r}: unknown kind {kind!r} "
                f"(one of {', '.join(_KINDS)})"
            )
        clauses.append(
            FaultClause(
                point=point,
                occurrence=occurrence,
                kind=kind,
                param=param.strip() or None,
            )
        )
    if not clauses:
        raise ValueError(f"fault spec {spec!r} contains no clauses")
    return FaultPlan(tuple(clauses))


#: the active plan — None is THE disabled state every fault_point checks
_PLAN: FaultPlan | None = None


def active() -> FaultPlan | None:
    return _PLAN


def install(plan: FaultPlan | str) -> FaultPlan:
    """Install a fault plan (replacing any active one) and return it."""
    global _PLAN
    if isinstance(plan, str):
        plan = parse_plan(plan)
    _PLAN = plan
    logger.warning("fault plan installed: %s", plan.render())
    return plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def install_from_env() -> FaultPlan | None:
    """(Re)install from ``PHOTON_FAULTS``: the training driver calls this
    at startup, so the environment controls the faults of each run; an
    empty or unset variable clears any active plan."""
    spec = os.environ.get(_ENV, "").strip()
    if not spec:
        clear()
        return None
    return install(spec)


@contextmanager
def injected(spec: str) -> Iterator[FaultPlan]:
    """Test scoping: install ``spec`` for the with-body, then restore the
    previous plan (tests never leak faults into each other)."""
    global _PLAN
    prev = _PLAN
    plan = install(spec)
    try:
        yield plan
    finally:
        _PLAN = prev


def fault_point(point: str) -> FaultClause | None:
    """THE instrumentation call. Disabled (no plan): two module-global
    reads, nothing else. Enabled: counts the arrival and executes the
    matched clause — raising kinds raise here; ``nan`` returns the
    clause for the site to act on; ``stall`` sleeps then returns it.
    """
    plan = _PLAN
    if plan is None:
        return None
    clause = plan.match(point)
    if clause is None:
        return None
    logger.warning("fault injected at %s: %s", point, clause.render())
    if clause.kind == "unavailable":
        raise InjectedFault(
            f"UNAVAILABLE: injected fault at {point!r} "
            f"({clause.render()})"
        )
    if clause.kind == "io_error":
        raise InjectedIOError(
            f"injected I/O fault at {point!r} ({clause.render()})"
        )
    if clause.kind == "error":
        raise InjectedFault(
            f"injected fatal fault at {point!r} ({clause.render()})"
        )
    if clause.kind == "crash":
        raise InjectedCrash(
            f"injected crash at {point!r} ({clause.render()})"
        )
    if clause.kind == "kill":
        logger.error("fault plan SIGKILLs the process at %r", point)
        os.kill(os.getpid(), signal.SIGKILL)
    if clause.kind == "stall":
        time.sleep(float(clause.param) if clause.param else 5.0)
    return clause


# a plan rides into a subprocess through the environment; the library
# honours it at import too, so a faulted run needs no code change
if os.environ.get(_ENV, "").strip():
    install_from_env()
