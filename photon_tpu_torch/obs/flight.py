"""Crash-surviving flight recorder: an mmap-backed ring of recent telemetry.

Counterpart of photon_tpu/obs/flight.py with the same ring and frame
format, so that each package reads the other's ring and blackbox. The
rest of the telemetry spine exports at the end of a run; a process killed
with SIGKILL takes its trace and metrics with it. The flight recorder is
the black box: a fixed-size, memory-mapped ring of the most recent
records, written at existing choke points (the serving engine's and the
scorer's read-backs, the descent's sweep barrier). The kernel owns the
dirty mmap pages, so after a SIGKILL the ring file holds what the dead
process last recorded, and a relaunch reconstructs it
(:func:`recover_stale`). The ring lives in host memory only: a process
holding a CUDA context dies the same way.

Ring format (``blackbox.ring``)
-------------------------------
A 64-byte header followed by a circular data region::

    header:  magic "PHOTONBB" | u32 version | u64 capacity
             | u64 next_seq | u64 write_off | u8 clean_closed
    frame:   magic b"\\xabFR1" | u32 payload_len | u64 seq
             | u32 crc32(payload) | payload (ASCII JSON)

Appends are sequence-stamped and CRC-framed; a frame that would cross the
end of the region zero-fills the remainder and wraps to offset 0 (frames
never split). The frame magic holds a non-ASCII byte and payloads are
``ensure_ascii`` JSON, so record content cannot forge a frame start.
Recovery scans the whole region and keeps every frame whose magic,
length, CRC and JSON check out; anything else (the torn frame a kill
interrupts) is skipped. Records sort by sequence number, so a wrapped
ring reads in order.

Append cost: one lock, one JSON encode of a small host dict, two mmap
stores; no syscall, no flush, no device work. With no recorder installed
:func:`record` is two module-global reads.

Crash dumps
-----------
:func:`install_crash_handler` chains ``sys.excepthook`` and a ``SIGTERM``
handler (the signal half only from the main thread); on an unhandled
exception or SIGTERM the handler writes ``blackbox-<seq>.json`` next to
the ring: its records, the last metric snapshot and the last health
scalars. SIGKILL cannot be caught; the ring plus :func:`recover_stale` on
the next launch covers it.
"""
from __future__ import annotations

import json
import logging
import mmap
import os
import signal
import struct
import sys
import threading
import time
import zlib
from typing import Any

logger = logging.getLogger(__name__)

RING_FILENAME = "blackbox.ring"

_HEADER_MAGIC = b"PHOTONBB"
_HEADER_FMT = "<8sIQQQB"  # magic, version, capacity, next_seq, write_off, clean
_HEADER_SIZE = 64  # fixed; struct occupies the prefix, rest reserved
_VERSION = 1

_FRAME_MAGIC = b"\xabFR1"  # non-ASCII first byte: unforgeable by JSON payloads
_FRAME_FMT = "<4sIQI"  # magic, payload_len, seq, crc32
_FRAME_HEADER = struct.calcsize(_FRAME_FMT)

#: default ring capacity in MiB (``PHOTON_OBS_RING_MB`` overrides; 0
#: disables the recorder entirely)
DEFAULT_RING_MB = 1.0


def ring_mb() -> float:
    """Configured ring capacity in MiB (env ``PHOTON_OBS_RING_MB``)."""
    env = os.environ.get("PHOTON_OBS_RING_MB", "").strip()
    if not env:
        return DEFAULT_RING_MB
    try:
        v = float(env)
    except ValueError as e:
        raise ValueError(
            f"PHOTON_OBS_RING_MB must be a number of MiB, got {env!r}"
        ) from e
    if v < 0:
        raise ValueError(f"PHOTON_OBS_RING_MB must be >= 0, got {env!r}")
    return v


class FlightRecorder:
    """One mmap-backed ring file. Thread-safe appends; reads scan the
    whole data region and keep only CRC-valid frames."""

    def __init__(self, path: str, capacity_bytes: int | None = None):
        if capacity_bytes is None:
            capacity_bytes = int(ring_mb() * 1024 * 1024)
        # floor: room for the header and at least one small frame
        capacity_bytes = max(int(capacity_bytes), 4096)
        self.path = str(path)
        self.capacity = capacity_bytes
        # REENTRANT: the SIGTERM crash handler runs on the main thread
        # between bytecodes, so it can fire while that same thread is
        # inside append() holding this lock — dump_blackbox's records()
        # re-acquiring a plain Lock would deadlock the dying process
        # instead of letting it terminate
        self._lock = threading.RLock()
        self._seq = 0
        self._off = 0
        self._closed = False
        self.dropped = 0  # records too large for the ring
        # monotonic timeline with ONE wall anchor so recovered records
        # can be placed in wall-clock time
        # phl-ok: PHL006 epoch anchor: the one wall capture; records step from the monotonic base
        self.epoch_wall_s = time.time()
        self._epoch_ns = time.perf_counter_ns()
        size = _HEADER_SIZE + capacity_bytes
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._write_header(clean=False)

    # -- writing -----------------------------------------------------------

    def _write_header(self, clean: bool) -> None:
        self._mm[: struct.calcsize(_HEADER_FMT)] = struct.pack(
            _HEADER_FMT,
            _HEADER_MAGIC,
            _VERSION,
            self.capacity,
            self._seq,
            self._off,
            1 if clean else 0,
        )

    def append(self, kind: str, fields: dict[str, Any]) -> int:
        """Append one record; returns its sequence number (-1 when the
        record did not fit or the recorder is closed). Never raises: the
        black box must not be able to fail the flight."""
        try:
            payload = json.dumps(
                {
                    "k": kind,
                    "t_s": round(
                        (time.perf_counter_ns() - self._epoch_ns) / 1e9, 6
                    ),
                    **fields,
                },
                default=str,
            ).encode("ascii")
        except Exception:
            logger.warning("unserializable flight record %r dropped", kind)
            return -1
        frame_len = _FRAME_HEADER + len(payload)
        with self._lock:
            if self._closed or frame_len > self.capacity:
                self.dropped += 1
                return -1
            seq = self._seq
            if self._off + frame_len > self.capacity:
                # zero-fill the remainder so a scanner cannot resync
                # into a stale frame fragment there, then wrap
                start = _HEADER_SIZE + self._off
                self._mm[start : _HEADER_SIZE + self.capacity] = b"\x00" * (
                    self.capacity - self._off
                )
                self._off = 0
            start = _HEADER_SIZE + self._off
            self._mm[start : start + frame_len] = (
                struct.pack(
                    _FRAME_FMT,
                    _FRAME_MAGIC,
                    len(payload),
                    seq,
                    zlib.crc32(payload),
                )
                + payload
            )
            self._off += frame_len
            self._seq += 1
            self._write_header(clean=False)
            return seq

    def close(self, clean: bool = True) -> None:
        """Flush and unmap. ``clean=True`` stamps the clean-closed marker
        so a later :func:`recover_stale` knows there is nothing to
        recover; ``clean=False`` simulates abrupt death (tests)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if clean:
                self._write_header(clean=True)
            self._mm.flush()
            self._mm.close()

    # -- reading -----------------------------------------------------------

    def records(self) -> list[dict]:
        """CRC-valid records currently in the ring, oldest first."""
        with self._lock:
            if self._closed:
                return []
            data = bytes(self._mm[_HEADER_SIZE : _HEADER_SIZE + self.capacity])
        return _scan_frames(data)

    def last_seq(self) -> int:
        with self._lock:
            return self._seq - 1

    @staticmethod
    def read_file(path: str) -> tuple[list[dict], bool]:
        """Read a ring FILE (typically another — possibly dead —
        process's): returns ``(records oldest-first, clean_closed)``.
        Torn or partially overwritten frames are skipped; a torn HEADER
        degrades to ``clean_closed=False`` plus whatever frames scan
        out of the rest of the file."""
        with open(path, "rb") as f:
            raw = f.read()
        clean = False
        if len(raw) >= struct.calcsize(_HEADER_FMT):
            magic, version, cap, _seq, _off, clean_b = struct.unpack(
                _HEADER_FMT, raw[: struct.calcsize(_HEADER_FMT)]
            )
            if magic == _HEADER_MAGIC and version == _VERSION:
                clean = bool(clean_b)
        return _scan_frames(raw[_HEADER_SIZE:]), clean


def _scan_frames(data: bytes) -> list[dict]:
    """Full-region frame scan: keep every frame whose magic, bounds,
    CRC, and JSON validate; anything else (the torn tail a kill
    interrupts, half-overwritten old frames, zero-fill at the wrap) is
    skipped by hopping to the next magic occurrence (``bytes.find`` —
    C speed, so a /blackbox scrape of a mostly-empty MiB ring is not a
    million-iteration Python loop). Frames sort by their sequence
    stamp, so a wrapped ring reads in order."""
    found: dict[int, dict] = {}
    n = len(data)
    i = data.find(_FRAME_MAGIC)
    while 0 <= i <= n - _FRAME_HEADER:
        plen, seq, crc = struct.unpack_from("<IQI", data, i + 4)
        end = i + _FRAME_HEADER + plen
        if plen == 0 or end > n:
            i = data.find(_FRAME_MAGIC, i + 1)
            continue
        payload = data[i + _FRAME_HEADER : end]
        if zlib.crc32(payload) != crc:
            # torn tail / partially overwritten frame: resync at the
            # next magic (which may live INSIDE this bad frame's span)
            i = data.find(_FRAME_MAGIC, i + 1)
            continue
        try:
            rec = json.loads(payload)
        except ValueError:
            i = data.find(_FRAME_MAGIC, i + 1)
            continue
        rec["seq"] = seq
        found[seq] = rec
        i = data.find(_FRAME_MAGIC, end)
    return [found[s] for s in sorted(found)]


# -- the process-global recorder -------------------------------------------

_recorder: FlightRecorder | None = None
_last_health: dict | None = None
_obs = None  # cached facade module (lazy: obs/__init__ imports this module)


def _facade():
    global _obs
    if _obs is None:
        from photon_tpu_torch import obs

        _obs = obs
    return _obs


def get_recorder() -> FlightRecorder | None:
    return _recorder


def record(kind: str, **fields) -> None:
    """Append a record to the installed recorder. With no recorder this
    is two module-global reads — hot-path taps (descent's sweep loop,
    the scoring consumer) cost nothing in the default configuration, and
    the tap reads only host values the barrier already fetched (no new
    syncs — sanitizer-pinned)."""
    r = _recorder
    if r is None:
        return
    global _last_health
    if "health" in fields:
        _last_health = fields["health"]
    r.append(kind, fields)
    _facade().counter("recorder.records")


def last_health() -> dict | None:
    """The most recent per-coordinate health row a tap carried (host
    values from the per-sweep barrier) — what ``/healthz`` and the
    crash dump report."""
    return _last_health


def enable(directory: str, capacity_bytes: int | None = None) -> FlightRecorder | None:
    """Install a process-global recorder writing ``blackbox.ring`` under
    ``directory``. Returns None (recorder disabled) when the configured
    ring size is 0."""
    global _recorder, _last_health
    if capacity_bytes is None:
        mb = ring_mb()
        if mb == 0:
            return None
        capacity_bytes = int(mb * 1024 * 1024)
    os.makedirs(directory, exist_ok=True)
    disable(clean=True)
    _last_health = None
    _recorder = FlightRecorder(
        os.path.join(directory, RING_FILENAME), capacity_bytes
    )
    return _recorder


def disable(clean: bool = True) -> None:
    """Close and uninstall the process-global recorder (no-op if none)."""
    global _recorder
    r = _recorder
    _recorder = None
    if r is not None:
        r.close(clean=clean)


def dump_blackbox(reason: str = "unknown") -> str | None:
    """Write ``blackbox-<seq>.json`` next to the live ring: its records
    plus the last metric snapshot and last health scalars. Best-effort —
    returns the path, or None when no recorder is installed or the dump
    itself failed (a dump must never mask the failure being dumped)."""
    r = _recorder
    if r is None:
        return None
    try:
        records = r.records()
        try:
            metrics = _facade().get_registry().snapshot()
        except Exception:
            metrics = None
        doc = {
            "reason": reason,
            "recovered": False,
            "pid": os.getpid(),
            "epoch_wall_s": r.epoch_wall_s,
            "last_seq": r.last_seq(),
            "last_health": _last_health,
            "last_sweep": _last_of(records, "sweep"),
            "last_coordinate": _last_of(records, "coordinate"),
            "metrics": metrics,
            "records": records,
        }
        path = os.path.join(
            os.path.dirname(r.path), f"blackbox-{max(r.last_seq(), 0)}.json"
        )
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path
    except Exception as e:  # pragma: no cover - defensive
        logger.warning("blackbox dump failed: %s: %s", type(e).__name__, e)
        return None


def _last_of(records: list[dict], kind: str) -> dict | None:
    for rec in reversed(records):
        if rec.get("k") == kind:
            return rec
    return None


def recover_stale(directory: str) -> str | None:
    """If ``directory`` holds a ring a DEAD process left behind (no
    clean-closed marker — e.g. a real SIGKILL mid-fit), reconstruct what
    it was doing into ``blackbox-<seq>.json`` and return the path.
    Returns None when there is no ring or the previous run closed
    cleanly. Call BEFORE :func:`enable` truncates the ring for this
    run.

    A multi-process run of the JAX package namespaces rings under
    ``<obs>/p<k>/``; one level of ``p*/`` children is scanned too, and
    every dead worker's ring is recovered into its own directory. The
    primary (own-dir) recovery path is returned."""
    first_child: str | None = None
    try:
        with os.scandir(directory) as it:
            children = sorted(
                e.path
                for e in it
                if e.is_dir()
                and e.name.startswith("p")
                and e.name[1:].isdigit()
            )
    except OSError:
        children = []
    for child in children:
        if os.path.exists(os.path.join(child, RING_FILENAME)):
            out = recover_stale(child)
            if out is not None and first_child is None:
                first_child = out
    own = _recover_one(directory)
    return own if own is not None else first_child


def _recover_one(directory: str) -> str | None:
    path = os.path.join(directory, RING_FILENAME)
    if not os.path.exists(path):
        return None
    try:
        records, clean = FlightRecorder.read_file(path)
    except Exception as e:
        logger.warning(
            "stale flight ring %s unreadable (%s: %s); skipping recovery",
            path, type(e).__name__, e,
        )
        return None
    if clean:
        return None
    last_seq = records[-1]["seq"] if records else 0
    last_sweep = _last_of(records, "sweep")
    doc = {
        "reason": "recovered from stale ring (previous process died "
        "without a clean close)",
        "recovered": True,
        "pid": os.getpid(),
        "last_seq": last_seq,
        "last_health": (last_sweep or {}).get("health"),
        "last_sweep": last_sweep,
        "last_coordinate": _last_of(records, "coordinate"),
        "metrics": _last_of(records, "metrics"),
        "records": records,
    }
    # never overwrite an existing dump: a SIGTERM'd run may have written
    # a crash-time blackbox-<seq>.json (with the full live metrics
    # snapshot) AND died before a clean ring close — the recovered doc
    # is the poorer artifact and must not replace it
    out = os.path.join(directory, f"blackbox-{last_seq}.json")
    if os.path.exists(out):
        out = os.path.join(directory, f"blackbox-{last_seq}-recovered.json")
    if os.path.exists(out):
        logger.info(
            "stale ring already recovered (%s exists); skipping", out
        )
        return None
    try:
        with open(out, "w") as f:
            json.dump(doc, f, default=str)
    except OSError as e:
        logger.warning("blackbox recovery write failed: %s", e)
        return None
    _facade().counter("recorder.recovered_rings")
    logger.warning(
        "recovered %d flight records from a dead run's ring -> %s "
        "(last sweep: %s)",
        len(records), out,
        None if last_sweep is None else last_sweep.get("iteration"),
    )
    return out


# -- crash handlers ---------------------------------------------------------

_prev_excepthook = None
_prev_sigterm = None
_handlers_installed = False


def _crash_excepthook(exc_type, exc, tb):
    dump_blackbox(reason=f"unhandled {exc_type.__name__}: {exc}")
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _crash_signal(signum, frame):
    dump_blackbox(reason=f"fatal signal {signal.Signals(signum).name}")
    # restore + re-raise so the default disposition (termination, exit
    # status) is preserved for the supervisor watching this process
    signal.signal(signum, _prev_sigterm or signal.SIG_DFL)
    signal.raise_signal(signum)


def install_crash_handler() -> None:
    """Chain a blackbox dump onto unhandled exceptions and SIGTERM.
    Main-thread only for the signal half (Python restriction); the
    excepthook half always installs. Idempotent."""
    global _prev_excepthook, _prev_sigterm, _handlers_installed
    if _handlers_installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _crash_excepthook
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _crash_signal)
    except ValueError:  # not the main thread
        _prev_sigterm = None
    _handlers_installed = True


def uninstall_crash_handler() -> None:
    global _handlers_installed, _prev_excepthook, _prev_sigterm
    if not _handlers_installed:
        return
    if sys.excepthook is _crash_excepthook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    if _prev_sigterm is not None:
        try:
            if signal.getsignal(signal.SIGTERM) is _crash_signal:
                signal.signal(signal.SIGTERM, _prev_sigterm)
        except ValueError:  # pragma: no cover - not the main thread
            pass
    _prev_excepthook = None
    _prev_sigterm = None
    _handlers_installed = False
