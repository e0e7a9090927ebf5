"""One-time-cost telemetry: what the port pays inside a traffic window that
a warm-up should have paid before it.

Counterpart of photon_tpu/util/compile_watch.py. JAX counts XLA backend
compiles through ``jax.monitoring``. The port has no compile step; what
the serving gate protects against is the same thing, a one-time cost paid
while requests wait. So the port counts:

- ``cold_dispatches`` (a): score-program dispatches at a batch-shape key
  that ``GameScorer.precompile`` did not warm. Each key counts once per
  scorer, on its first dispatch, as a JAX jit compiles each shape once;
- ``native_builds`` / ``native_build_s`` (b): builds of the port's native
  libraries (``nvcc`` of ``csrc/*.cu``, ``g++`` of ``native/*.cpp``),
  with their walls;
- ``allocator_segments`` (c): new segments of PyTorch's caching
  allocator on the card (``segment.all.allocated``: each is one
  ``cudaMalloc``), read from the allocator at snapshot time; 0 on the CPU.

``backend_compiles`` is (a) + (b) and ``backend_compile_s`` their build
walls, so the consumers of JAX's key (the serving engine's summary, the
zero-traffic-compile gate) read both packages the same way. (c) is
reported under its own key and is not part of the gate.

:func:`snapshot` / :func:`delta` / :func:`watch` work as in JAX;
:func:`install` is idempotent and has nothing to register.
"""
from __future__ import annotations

import contextlib
import threading

_LOCK = threading.Lock()

_ZERO = {
    "backend_compiles": 0,
    "backend_compile_s": 0.0,
    "cold_dispatches": 0,
    "native_builds": 0,
    "native_build_s": 0.0,
    "allocator_segments": 0,
}

_totals = {k: v for k, v in _ZERO.items() if k != "allocator_segments"}


def _bump(**increments) -> None:
    from photon_tpu_torch import obs

    with _LOCK:
        for k, v in increments.items():
            _totals[k] += v
    for k, v in increments.items():
        obs.counter(f"compile.{k}", v)


def record_cold_dispatch() -> None:
    """A score program ran at a shape key no warm-up covered."""
    _bump(cold_dispatches=1, backend_compiles=1)


def record_native_build(name: str, seconds: float) -> None:
    """A native library was compiled in this process."""
    _bump(native_builds=1, native_build_s=float(seconds), backend_compiles=1,
          backend_compile_s=float(seconds))


def install() -> bool:
    """Nothing to register (the counters are pushed by their sites);
    kept so that callers written for JAX's API run unchanged."""
    return True


def installed() -> bool:
    return True


def snapshot() -> dict:
    """The cumulative process-global counters, with the allocator's
    segment count read now."""
    from photon_tpu_torch.obs.memory import allocator_stats

    with _LOCK:
        out = dict(_totals)
    out["allocator_segments"] = allocator_stats()["segments_allocated"]
    return out


def delta(before: dict, after: dict | None = None) -> dict:
    """``after − before`` fieldwise; ``after`` defaults to now."""
    if after is None:
        after = snapshot()
    out = {}
    for k, z in _ZERO.items():
        d = after.get(k, z) - before.get(k, z)
        out[k] = round(d, 4) if isinstance(z, float) else d
    return out


@contextlib.contextmanager
def watch():
    """``with watch() as stats: ...``: ``stats`` holds the region's delta
    on exit."""
    before = snapshot()
    stats: dict = {}
    try:
        yield stats
    finally:
        stats.update(delta(before))
