"""Device-memory ledger: warm-up footprints, live censuses, transfer bytes.

Counterpart of photon_tpu/obs/memory.py on PyTorch's caching allocator.
JAX enumerates ``jax.live_arrays()``; the port reads
``torch.cuda.memory_stats()`` instead:

- **Footprints** (:meth:`MemoryLedger.record_executable`): what a warmed
  program needed. JAX records XLA's ``memory_analysis()`` of each AOT
  executable; the port has no compile step, so ``GameScorer.precompile``
  records the allocator's growth over its warm-up dispatch (bytes
  allocated and reserved, segments added) under the same kind of label,
  ``score:<shape key>``. Footprints survive :func:`photon_tpu_torch.obs.
  reset`, as JAX's do.
- **Censuses** (:meth:`MemoryLedger.census`): at phase boundaries only
  (serving start and end, stream start and end), the allocator's
  allocated and reserved bytes, current and peak, and its segment
  counts. Host reads of the allocator's counters: no device work, no
  synchronization. Censuses drive the ``mem.live_bytes`` gauge and the
  ``mem.peak_bytes`` high-watermark.
- **Transfers** (:meth:`MemoryLedger.count_h2d` / :meth:`count_d2h`):
  bytes crossing the host/device boundary at the scorer's and the serving
  engine's staging and read-back.

On the CPU (or before CUDA is initialized) a census reports zero device
bytes: the port's host tensors are not device memory. (A JAX CPU run
instead reports its host buffers, which ``jax.live_arrays()`` lists.)

- **Residency** (:class:`ResidencyGuard`): a streaming fit's bound on
  the allocator's bytes over the baseline taken when the guard was armed,
  sampled at every chunk placement; a breach raises
  :class:`ResidencyError`.

Censuses and transfer counters are live while the obs pipeline is enabled
and ``PHOTON_OBS_MEM`` is not ``0``; an armed guard samples whatever the
pipeline's state.
"""
from __future__ import annotations

import dataclasses
import os
import threading

import torch

__all__ = [
    "MemoryLedger",
    "ResidencyError",
    "ResidencyGuard",
    "allocator_stats",
    "census",
    "count_d2h",
    "count_h2d",
    "enabled",
    "get_ledger",
    "live_device_bytes",
    "record_executable",
    "tree_device_bytes",
]

#: the allocator counters a census row carries (``torch.cuda.memory_stats``)
_STAT_KEYS = {
    "allocated_bytes": "allocated_bytes.all.current",
    "peak_allocated_bytes": "allocated_bytes.all.peak",
    "reserved_bytes": "reserved_bytes.all.current",
    "peak_reserved_bytes": "reserved_bytes.all.peak",
    "segments": "segment.all.current",
    "segments_allocated": "segment.all.allocated",
}


def allocator_stats() -> dict:
    """The caching allocator's counters of the current card (all zero on a
    process that has not initialized CUDA, which this never does)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {k: 0 for k in _STAT_KEYS}
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(src, 0)) for k, src in _STAT_KEYS.items()}


class MemoryLedger:
    """Thread-safe memory accounting (see the module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._executables: dict[str, dict] = {}
        self._censuses: list[dict] = []
        self._peak_bytes = 0
        self._h2d_bytes = 0
        self._d2h_bytes = 0

    def record_executable(self, label: str, footprint: dict) -> dict:
        """Record the warm-up footprint of one program (a dict of byte
        counts) under ``label``; ``total_bytes`` is its allocated bytes."""
        entry = {k: int(v) for k, v in footprint.items()}
        entry.setdefault("total_bytes", entry.get("allocated_bytes", 0))
        with self._lock:
            self._executables[label] = entry
        return entry

    def census(self, phase: str) -> dict:
        """One census row at a phase boundary (host reads only)."""
        from photon_tpu_torch import obs

        row = {"phase": phase, **allocator_stats()}
        row["live_bytes"] = row["allocated_bytes"]
        with self._lock:
            self._censuses.append(row)
            self._peak_bytes = max(self._peak_bytes, row["live_bytes"], row["peak_allocated_bytes"])
            peak = self._peak_bytes
        obs.counter("mem.censuses")
        obs.gauge("mem.live_bytes", row["live_bytes"])
        obs.gauge("mem.peak_bytes", peak)
        return row

    def count_h2d(self, nbytes: int) -> None:
        from photon_tpu_torch import obs

        with self._lock:
            self._h2d_bytes += int(nbytes)
        obs.counter("mem.h2d_bytes", int(nbytes))

    def count_d2h(self, nbytes: int) -> None:
        from photon_tpu_torch import obs

        with self._lock:
            self._d2h_bytes += int(nbytes)
        obs.counter("mem.d2h_bytes", int(nbytes))

    def report(self) -> dict:
        """The ledger as plain data: what ``memory_report.json`` holds."""
        with self._lock:
            execs = {k: dict(v) for k, v in self._executables.items()}
            rows = [dict(r) for r in self._censuses]
            peak, h2d, d2h = self._peak_bytes, self._h2d_bytes, self._d2h_bytes
        return {
            "executables": execs,
            "executables_total": {
                "n": len(execs),
                "total_bytes": sum(v.get("total_bytes", 0) for v in execs.values()),
            },
            "censuses": rows,
            "peak_live_bytes": peak,
            "h2d_bytes": h2d,
            "d2h_bytes": d2h,
        }

    def reset_run_state(self) -> None:
        """Artifact boundary (``obs.reset``): drop censuses and transfer
        counters, keep the footprints of warmed programs."""
        with self._lock:
            self._censuses.clear()
            self._peak_bytes = 0
            self._h2d_bytes = 0
            self._d2h_bytes = 0

    def clear(self) -> None:
        with self._lock:
            self._executables.clear()
        self.reset_run_state()


_ledger = MemoryLedger()


def get_ledger() -> MemoryLedger:
    return _ledger


def enabled() -> bool:
    """Censuses and transfer counters are live while the obs pipeline is
    on and ``PHOTON_OBS_MEM`` is not ``0``."""
    from photon_tpu_torch import obs

    return obs.enabled() and os.environ.get("PHOTON_OBS_MEM", "").strip() != "0"


def record_executable(label: str, footprint: dict) -> dict:
    return _ledger.record_executable(label, footprint)


def census(phase: str) -> dict | None:
    """A census on the default ledger; None while the ledger is off."""
    if not enabled():
        return None
    return _ledger.census(phase)


def count_h2d(nbytes: int) -> None:
    if enabled() and nbytes:
        _ledger.count_h2d(nbytes)


def count_d2h(nbytes: int) -> None:
    if enabled() and nbytes:
        _ledger.count_d2h(nbytes)


def live_device_bytes() -> int:
    """Bytes the caching allocator has handed out on the current card (0 on
    the CPU)."""
    return allocator_stats()["allocated_bytes"]


class ResidencyError(RuntimeError):
    """A streaming fit's live device bytes exceeded its declared bound."""


class ResidencyGuard:
    """The bounded-residency assertion of a streaming fit: ``limit_bytes``
    (``2 × chunk bytes + tables + slack``) over the allocator's bytes when
    the guard was armed. The chunk pipeline calls :meth:`sample` at every
    placement, where residency peaks; the running peak feeds the stream
    report and the ``mem.peak_bytes`` watermark. One host read of the
    allocator's counters per sample (0 bytes on the CPU). Built per fit."""

    def __init__(self, limit_bytes: int):
        self.limit_bytes = int(limit_bytes)
        self.baseline_bytes = live_device_bytes()
        self.peak_bytes = self.baseline_bytes
        self.samples = 0

    def sample(self) -> int:
        """Read the live device bytes, update the peak and raise
        :class:`ResidencyError` when the bytes over the baseline exceed
        the limit. Returns the live bytes."""
        from photon_tpu_torch import obs

        live = live_device_bytes()
        self.samples += 1
        if live > self.peak_bytes:
            self.peak_bytes = live
            with _ledger._lock:
                _ledger._peak_bytes = max(_ledger._peak_bytes, live)
                peak = _ledger._peak_bytes
            obs.gauge("mem.peak_bytes", peak)
        over = live - self.baseline_bytes
        if over > self.limit_bytes:
            raise ResidencyError(
                f"train.stream: live device residency {live} B ({over} B over the "
                f"{self.baseline_bytes} B baseline) exceeds the declared streaming "
                f"budget of {self.limit_bytes} B (2 x chunk bytes + tables); the "
                "chunk pipeline is retaining more than its double buffer"
            )
        return live

    def report(self) -> dict:
        return {
            "baseline_bytes": self.baseline_bytes,
            "limit_bytes": self.limit_bytes,
            "peak_bytes": self.peak_bytes,
            "peak_over_baseline_bytes": self.peak_bytes - self.baseline_bytes,
            "samples": self.samples,
        }


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def tree_device_bytes(tree) -> int:
    """Σ ``nbytes`` over the tensors of a nested dict, list, tuple or
    dataclass (metadata only): the placement bill of a scorer's tables or
    of a staged batch. The tensors count on the device they were placed
    on, the card's memory for a ``device="cuda"`` scorer and host memory
    for a ``device="cpu"`` one (as JAX's CPU backend counts its host
    buffers), so the serving registry prices a model on either."""
    return sum(t.nbytes for t in _leaves(tree))
