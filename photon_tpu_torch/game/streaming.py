"""Out-of-core streaming training: the dataset stays on the host and every
sweep streams fixed-shape chunks through a two-deep host→device pipeline.

Counterpart of photon_tpu/game/streaming.py. The materialized coordinates
(game/coordinate.py) place the whole dataset on the card before the first
sweep, so the card's memory caps the rows a fit can take. A streaming fit
keeps the random-effect buckets and the fixed-effect CSR shard in host
memory, and keeps the coordinate states, the [N] score columns and the
total there too, as CPU tensors. Each sweep streams chunks: a producer
thread assembles chunk k+1 on the host, copies it into a page-locked slot
and from there to the card on a copy stream behind an event, while the
consumer solves chunk k on the compute stream, which waits on that event
before it reads the chunk. At most ``DEVICE_SLOTS`` = 2 chunks are on the
card at once (a slot is refilled only after the chunk that held it was
retired), so device residency is bounded at **2 chunks + tables**, which
an armed :class:`photon_tpu_torch.obs.memory.ResidencyGuard` checks at
every placement.

Bit parity with the materialized fit holds by construction:

- a random-effect solve chunk goes through the same function as a
  materialized bucket (``coordinate.solve_lanes``) on [ec, rows, d]
  lanes of the bucket, with ``ec = min(max(1, chunk_rows // rows), E)``:
  a bucket that fits in one chunk solves with exactly the materialized
  [E, rows, d] batch. A bucket that needs several chunks is deterministic
  for its chunk geometry, and within roundoff of the materialized bucket,
  not equal to it: the batched products may take another path for
  another batch count (a batch of one lane is a plain matrix product on
  the CPU; cuBLAS may pick another algorithm on the card);
- the score chunks go through ``coordinate.score_rows`` and
  ``FixedEffectCoordinate.score_batch``, whose output rows each depend on
  their own input row only;
- the host residual gather and fold (``coordinate.fold_residual``), the
  new total ``residual + score`` and the score write ``out[pos] = s`` are
  the same elementwise operations, at the same dtype, as the device's.

What a streaming fit refuses, at fit entry (:func:`validate_streaming`):
trainable fixed-effect coordinates (the global L-BFGS needs every row at
every iteration; a locked one streams its score), matrix factorization,
per-sweep device validation and coefficient variances. A locked fixed
effect is densified chunk by chunk into [chunk_rows, D] blocks, as the
JAX package does, so a wide shard (D = 2¹⁷) streams 4 GiB a chunk.

Health: the per-sweep loss and gradient norm are summed on the host in
chunk order, so they differ from the materialized values by roundoff;
the coefficients do not.

Telemetry, with the JAX package's names: ``train.stream.*`` spans,
``train.stream.stage_seconds.<stage>`` histograms (queue, h2d, dispatch,
readback, pipeline), ``train.stream.producer_deaths`` and
``train.stream.stalls``, and ``mem.h2d_bytes``. Fault points
(util/faults.py): ``train.stream.producer`` (outside the producer's
failure hand-off, so an ``error`` kills the thread, which the watchdog
turns into :class:`ProducerDiedError`), ``train.stream.chunk`` (per chunk,
handed to the consumer) and ``train.stream.h2d`` (the consumer, before it
takes a staged chunk). ``compile_watch`` counts the first dispatch at
each chunk shape as a one-time cost, so sweeps from 1 on count 0. The
shape keys are JAX's (``Coordinate.programs``): ``("stream_solve", ec,
rows, d, False)`` per solve chunk shape and ``("stream_score",
chunk_rows, d, False)`` per random-effect score chunk shape, and
``("stream_score", chunk_rows, False)`` for a locked fixed effect. Each
coordinate's ``precompile_specs`` warms every such key once, on one
chunk staged through a page-locked slot and the copy stream as a stream
stages it, with at most one chunk on the card (under the residency
bound), and outside ``run_stream``: no fault point, work counter or
pipeline accounting of the fit sees it.
Causal tracing (obs/causal.py, ``PHOTON_TRACE``): one ``train.chunk``
trace per chunk, minted on the producer before the chunk is assembled
(so a ``train.stream.chunk`` fault lands inside it) and carried on the
staged item to the consumer: ``train.produce`` and ``train.h2d`` slices on
the producer's track, ``train.dispatch`` and ``train.readback`` on the
consumer's, flows from produce through dispatch to the read-back. Each
chunk's dispatch is one launch site of the descent's work counter
(``obs.record_dispatch``), as in JAX.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.game.config import (
    FixedEffectCoordinateConfig,
    MatrixFactorizationCoordinateConfig,
)
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    _to_host,
    device_barrier,
    fold_residual,
    one_iteration,
    score_rows,
    solve_lanes,
)
from photon_tpu_torch.game.data import GameData, RandomEffectDataset
from photon_tpu_torch.game.model import BucketCoefficients, RandomEffectModel
from photon_tpu_torch.game.scoring import ProducerDiedError, StreamStallError, stream_watchdog_s
from photon_tpu_torch.obs import causal
from photon_tpu_torch.obs import memory as obs_memory
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optimize.problem import GLMProblem
from photon_tpu_torch.types import LabeledBatch, numpy_dtype
from photon_tpu_torch.util import faults

logger = logging.getLogger(__name__)

__all__ = [
    "DEVICE_SLOTS",
    "RESIDENCY_SLACK_BYTES",
    "StreamConfig",
    "StreamTelemetry",
    "StreamingFixedEffectCoordinate",
    "StreamingModeError",
    "StreamingRandomEffectCoordinate",
    "run_stream",
    "stream_chunk_rows",
    "validate_streaming",
]

DEFAULT_CHUNK_ROWS = 8192
#: chunks on the card at most: the one being computed and the one staged
#: behind it (also the depth of the producer's hand-off queue)
DEVICE_SLOTS = 2
#: allowance on top of the structural residency bound for the allocator's
#: rounding and small per-chunk outputs
RESIDENCY_SLACK_BYTES = 8 << 20

Tensor = torch.Tensor
_HOST = torch.device("cpu")


class StreamingModeError(ValueError):
    """A fit the streaming mode does not support, refused at fit entry (or
    at model export), never degraded silently."""


def stream_chunk_rows(config_value: int | None = None) -> int:
    """Rows per training chunk: ``PHOTON_STREAM_CHUNK_ROWS`` env > the
    given value > DEFAULT_CHUNK_ROWS."""
    env = os.environ.get("PHOTON_STREAM_CHUNK_ROWS", "").strip()
    if env:
        v = int(env)
    elif config_value is not None:
        v = int(config_value)
    else:
        return DEFAULT_CHUNK_ROWS
    if v < 1:
        raise ValueError(f"stream chunk rows must be >= 1, got {v}")
    return v


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The pipeline's knobs. ``chunk_rows`` sets every chunk shape: a
    fixed-effect or random-effect score chunk holds ``chunk_rows`` rows,
    a random-effect solve chunk ``max(1, chunk_rows // rows)`` entity
    lanes of its bucket's [rows, d] level (clamped to the bucket's entity
    count). Last chunks are zero-padded to the fixed shape."""

    chunk_rows: int = DEFAULT_CHUNK_ROWS
    #: arm the residency guard: fail when the allocator's bytes exceed
    #: the baseline + 2 × chunk bytes + tables + RESIDENCY_SLACK_BYTES
    assert_residency: bool = True

    @staticmethod
    def resolve(value) -> "StreamConfig":
        """A ``fit(stream=...)`` request as a StreamConfig: an int is the
        chunk rows, a StreamConfig passes (the environment still wins on
        ``chunk_rows``)."""
        if isinstance(value, StreamConfig):
            return dataclasses.replace(value, chunk_rows=stream_chunk_rows(value.chunk_rows))
        if isinstance(value, int) and not isinstance(value, bool):
            return StreamConfig(chunk_rows=stream_chunk_rows(value))
        raise TypeError(f"stream must be a StreamConfig or an int chunk size; got {value!r}")


def validate_streaming(coordinate_configs, locked_coordinates, *, device_validation: bool) -> None:
    """Raise :class:`StreamingModeError` for what a streaming fit does not
    support (the module docstring); ``device_validation`` is a fit with
    validation data and an evaluator."""
    if device_validation:
        raise StreamingModeError(
            "streaming fits do not support the device validation scorer (it "
            "materializes the validation set on the device); evaluate the "
            "returned model on the host instead"
        )
    for cid, cfg in coordinate_configs.items():
        if isinstance(cfg, MatrixFactorizationCoordinateConfig):
            raise StreamingModeError(
                f"coordinate {cid!r}: matrix-factorization coordinates are not "
                "streamable (factor-table training gathers arbitrary rows per chunk)"
            )
        if isinstance(cfg, FixedEffectCoordinateConfig) and cid not in locked_coordinates:
            raise StreamingModeError(
                f"coordinate {cid!r}: streaming fits require fixed-effect "
                "coordinates to be LOCKED (the global L-BFGS cannot train "
                "bit-exactly from chunks); train it materialized first, then "
                "stream with it locked"
            )
        if cfg.optimization.variance_computation.value != "NONE":
            raise StreamingModeError(
                f"coordinate {cid!r}: streaming fits do not compute coefficient "
                "variances; set variance_computation=NONE"
            )


class StreamTelemetry:
    """One fit's pipeline accounting: the stage walls, chunks and streams,
    H2D bytes, and the H2D share counted as overlapped. A staging counts
    as overlapped when it began while a chunk of the same stream was
    dispatched and not yet retired; that it overlapped on the card is
    what a profiled run measures."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stage_s: dict[str, float] = {}
        self.chunks = 0
        self.streams = 0
        self.h2d_bytes = 0
        self.overlapped_h2d_s = 0.0
        self.overlapped_h2d_bytes = 0
        #: armed by the estimator unless assert_residency is off
        self.guard: obs_memory.ResidencyGuard | None = None

    def record_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stage_s[stage] = self.stage_s.get(stage, 0.0) + seconds
        obs.histogram(f"train.stream.stage_seconds.{stage}", seconds)

    def record_chunk(self, nbytes: int, h2d_s: float, overlapped: bool) -> None:
        with self._lock:
            self.chunks += 1
            self.h2d_bytes += int(nbytes)
            if overlapped:
                self.overlapped_h2d_s += h2d_s
                self.overlapped_h2d_bytes += int(nbytes)
        obs_memory.count_h2d(int(nbytes))

    def overlap_fraction(self) -> float:
        """The share of the H2D staging wall counted as overlapped."""
        total = self.stage_s.get("h2d", 0.0)
        return self.overlapped_h2d_s / total if total > 0.0 else 0.0

    def report(self) -> dict:
        with self._lock:
            out = {
                "chunks": self.chunks,
                "streams": self.streams,
                "h2d_bytes": self.h2d_bytes,
                "overlapped_h2d_bytes": self.overlapped_h2d_bytes,
                "stage_seconds": {k: round(v, 6) for k, v in sorted(self.stage_s.items())},
                "overlapped_h2d_seconds": round(self.overlapped_h2d_s, 6),
            }
        out["h2d_overlap_fraction"] = round(self.overlap_fraction(), 4)
        if self.guard is not None:
            out["residency"] = self.guard.report()
        return out


# -- the chunk pipeline -------------------------------------------------------

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class _Staged:
    """A chunk on the device: ``meta`` for the sink, the device tensors,
    the event behind their copy (None on the CPU) and the staging's
    accounting."""

    meta: object
    dev: tuple
    event: object
    nbytes: int
    h2d_s: float
    overlapped: bool
    trace: object  # the chunk's causal trace (obs/causal.py)


class _Stager:
    """Host chunk → device. On the card each chunk's tensors go through
    one of ``DEVICE_SLOTS`` page-locked slots (one buffer per shape and
    dtype, reused) and are copied on a copy stream of their own, with an
    event recorded behind the copy; on the CPU the host tensors are the
    chunk. Used from the producer thread only."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.index = device.index if device.index is not None else torch.cuda.current_device()
            self.copy_stream = torch.cuda.Stream(device)
            self.pinned: list[dict] = [{} for _ in range(DEVICE_SLOTS)]
            self.copied: list = [None] * DEVICE_SLOTS
            self.slot = 0

    def stage(self, host: tuple) -> tuple:
        if not self.cuda:
            return host, None
        slot = self.slot
        self.slot = (slot + 1) % DEVICE_SLOTS
        if self.copied[slot] is not None:
            with obs.host_sync("stream.slot_reuse"):
                # phl-ok: PHL002 staging slot reuse: the slot's last copy must land
                self.copied[slot].synchronize()  # the slot's last copy has landed
        bufs = []
        for i, t in enumerate(host):
            key = (i, tuple(t.shape), t.dtype)
            buf = self.pinned[slot].get(key)
            if buf is None:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.pinned[slot][key] = buf
            buf.copy_(t)
            bufs.append(buf)
        with torch.cuda.stream(self.copy_stream):
            # phl-ok: PHL007 a streamed chunk is per-process: a streaming fit refuses a mesh
            dev = tuple(b.to(self.device, non_blocking=True) for b in bufs)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self.copied[slot] = event
        return dev, event


class _Flight:
    """Chunks of one stream dispatched and not yet retired (the consumer
    writes it, the producer reads it to count an overlapped staging)."""

    def __init__(self):
        self.count = 0


def _produce(chunks: Iterator, q: queue.Queue, stop: threading.Event,
             slots: threading.Semaphore, stager: _Stager, flight: _Flight) -> None:
    """Producer thread: assemble each host chunk, wait for a free device
    slot, stage it and hand it over through the bounded queue. The
    ``train.stream.producer`` fault point sits outside the failure
    hand-off, so an injected error kills the thread with no word, which
    the consumer's watchdog turns into ProducerDiedError; a
    ``train.stream.chunk`` fault is handed over. Every wait is bounded by
    ``stop``, so a failed consumer never leaves this thread blocked."""
    faults.fault_point("train.stream.producer")

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    ctx = causal.null()
    try:
        if stager.cuda:
            torch.cuda.set_device(stager.index)
        while not stop.is_set():
            t_pull = time.perf_counter()
            # one trace per chunk, minted before assembly so a chunk fault
            # lands inside this chunk's chain
            ctx = causal.mint("train.chunk", kind="train")
            with ctx.active():
                faults.fault_point("train.stream.chunk")
                item = next(chunks, _DONE)
            if item is _DONE:
                put(_DONE)
                return
            ctx.event("train.produce", t_pull, time.perf_counter() - t_pull, cat="train")
            ctx.flow("s", t_pull)
            meta, host = item
            while not slots.acquire(timeout=0.05):
                if stop.is_set():
                    return
            t0 = time.perf_counter()
            overlapped = flight.count > 0
            dev, event = stager.stage(host)
            h2d_s = time.perf_counter() - t0
            nbytes = sum(t.nbytes for t in host)
            ctx.event("train.h2d", t0, h2d_s, cat="train", nbytes=int(nbytes))
            if not put(_Staged(meta, dev, event, nbytes, h2d_s, overlapped, ctx)):
                return
            ctx = causal.null()  # the consumer owns it now
    except BaseException as e:  # handed to the consumer, which raises it
        ctx.finish("error")
        put(_Failure(e))


def _next_item(q: queue.Queue, producer: threading.Thread, watchdog_s: float):
    """The watchdog-guarded hand-off: a dead producer with an empty queue
    is ProducerDiedError, one silent past the watchdog StreamStallError."""
    waited = 0.0
    poll = 0.5 if watchdog_s == 0 else min(0.5, watchdog_s)
    while True:
        try:
            return q.get(timeout=poll)
        except queue.Empty:
            pass
        if not producer.is_alive():
            try:  # it may have put and exited between the two checks
                return q.get_nowait()
            except queue.Empty:
                obs.counter("train.stream.producer_deaths")
                raise ProducerDiedError(
                    "training chunk producer thread died without reporting a result "
                    "or an error; the streaming sweep cannot make progress"
                ) from None
        waited += poll
        if watchdog_s and waited >= watchdog_s:
            obs.counter("train.stream.stalls")
            raise StreamStallError(
                f"training chunk producer produced nothing for {waited:.0f}s (watchdog "
                f"PHOTON_STREAM_WATCHDOG_S={watchdog_s:g}); treating the stream as hung"
            )


def run_stream(chunks: Iterator, run_fn: Callable, sink_fn: Callable, *,
               telemetry: StreamTelemetry, device: torch.device, label: str) -> int:
    """Drive one stream of host chunks through the two-deep pipeline.

    ``chunks`` yields ``(meta, host_tensors)`` (a tuple of CPU tensors)
    and runs on the producer thread, which stages each chunk (the ``h2d``
    wall). Per chunk the consumer then: takes it from the queue (the
    ``queue`` wall); samples the armed residency guard, with this chunk
    and the previous one on the card; retires the previous chunk,
    ``sink_fn(meta, out)`` reading its outputs back (the ``readback``
    wall), which frees its device slot so the producer stages the next
    chunk while this one computes; makes the compute stream wait on this
    chunk's copy and calls ``run_fn(meta, dev) -> out`` (the ``dispatch``
    wall). Returns the number of chunks."""
    causal.ensure_from_env()
    q: queue.Queue = queue.Queue(maxsize=DEVICE_SLOTS)
    stop = threading.Event()
    slots = threading.Semaphore(DEVICE_SLOTS)
    flight = _Flight()
    stager = _Stager(device)
    compute = torch.cuda.current_stream(device) if stager.cuda else None
    producer = threading.Thread(
        target=_produce, args=(chunks, q, stop, slots, stager, flight),
        name=f"train-stream-{label}", daemon=True,
    )
    producer.start()
    telemetry.streams += 1
    n_chunks = 0
    pending = None  # (meta, out, trace) of the chunk awaiting its read-back
    t_stream = time.perf_counter()

    def retire(held) -> None:
        meta, out, ctx = held
        t2 = time.perf_counter()
        sink_fn(meta, out)
        rb_s = time.perf_counter() - t2
        telemetry.record_stage("readback", rb_s)
        flight.count -= 1
        slots.release()
        # the flow finishes inside the read-back slice
        ctx.event("train.readback", t2, rb_s, cat="train")
        ctx.flow("f", t2)
        ctx.finish("ok")

    try:
        while True:
            t0 = time.perf_counter()
            item = _next_item(q, producer, stream_watchdog_s())
            telemetry.record_stage("queue", time.perf_counter() - t0)
            if isinstance(item, _Failure):
                raise item.exc
            if item is _DONE:
                break
            ctx = item.trace
            try:
                with ctx.active():
                    faults.fault_point("train.stream.h2d")
            except BaseException:
                ctx.finish("fault")
                raise
            telemetry.record_stage("h2d", item.h2d_s)
            telemetry.record_chunk(item.nbytes, item.h2d_s, item.overlapped)
            if telemetry.guard is not None:
                # the peak: this chunk and the previous one on the card
                telemetry.guard.sample()
            flight.count += 1  # before the retire frees a slot for the next staging
            if pending is not None:
                held, pending = pending, None
                retire(held)
                del held
            meta, dev = item.meta, item.dev
            if item.event is not None:
                compute.wait_event(item.event)
                for t in dev:
                    t.record_stream(compute)
            del item
            t3 = time.perf_counter()
            obs.record_dispatch()
            with ctx.active():
                out = run_fn(meta, dev)
            del dev
            dispatch_s = time.perf_counter() - t3
            telemetry.record_stage("dispatch", dispatch_s)
            ctx.event("train.dispatch", t3, dispatch_s, cat="train")
            ctx.flow("t", t3)
            pending = (meta, out, ctx)
            del out, ctx
            n_chunks += 1
        if pending is not None:
            held, pending = pending, None
            retire(held)
    finally:
        stop.set()
        while True:  # staged chunks left behind by a failure
            try:
                q.get_nowait()
            except queue.Empty:
                break
        producer.join(timeout=10.0)
    telemetry.record_stage("pipeline", time.perf_counter() - t_stream)
    return n_chunks


def _pad_rows(t: Tensor, rows: int) -> Tensor:
    """``t`` zero-padded along its first axis to ``rows``."""
    if t.shape[0] == rows:
        return t
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


def _warm_chunk(stager: _Stager, telemetry: StreamTelemetry, host: tuple, run_fn) -> None:
    """One warm-up chunk: staged through a page-locked slot and the copy
    stream of the coordinate's warm-up stager (one for all its keys, as a
    stream has one for all its chunks), computed on the compute stream
    behind the copy's event, read back, then dropped. The armed residency
    guard is sampled with it on the card. No fault point, work counter or
    stage accounting sees it."""
    device = stager.device
    dev, event = stager.stage(host)
    if event is not None:
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in dev:
            t.record_stream(compute)
    if telemetry is not None and telemetry.guard is not None:
        telemetry.guard.sample()
    out = run_fn(dev)
    del dev
    for t in out:
        with obs.host_sync("stream.warmup_readback"):
            # phl-ok: PHL002 the warm-up chunk's read-back, as a stream reads a chunk back
            t.to(_HOST)
    device_barrier(device)


# -- streaming fixed effect (locked: a score stream only) ---------------------


@dataclasses.dataclass(eq=False)
class StreamingFixedEffectCoordinate(FixedEffectCoordinate):
    """A locked fixed effect whose [N] score streams dense row chunks of
    the host CSR shard through ``FixedEffectCoordinate.score_batch``. The
    [N, D] block never exists on the card; each chunk is densified on the
    producer thread. The state is a CPU tensor; each score stream puts it
    on the card once (with the normalization's vectors, the "tables" of
    the residency bound). Training raises StreamingModeError."""

    shard_csr: object = None
    num_samples: int = 0
    stream: StreamConfig = None
    telemetry: StreamTelemetry = None

    @staticmethod
    def build_streaming(
        data: GameData,
        config: FixedEffectCoordinateConfig,
        normalization: NormalizationContext = NormalizationContext(),
        *,
        dtype: torch.dtype,
        device: torch.device,
        stream: StreamConfig,
        telemetry: StreamTelemetry,
    ) -> "StreamingFixedEffectCoordinate":
        # phl-ok: PHL007 a streaming fit refuses a mesh: its d-vectors are per-process
        normalization = normalization.to(device=device, dtype=dtype)
        problem = GLMProblem.build(
            config.optimization.with_regularization_weight(config.regularization_weights[0]),
            normalization,
        )
        shard = data.feature_shards[config.feature_shard]
        return StreamingFixedEffectCoordinate(
            config=config, batch=None, normalization=normalization, problem=problem,
            dtype=dtype, device=device, num_features=shard.num_cols, shard_csr=shard,
            num_samples=int(data.num_samples), stream=stream, telemetry=telemetry,
        )

    def initial_state(self) -> Tensor:
        return torch.zeros(self.num_features, dtype=self.dtype)

    def place_state(self, state: Tensor) -> Tensor:
        return state.detach().to(_HOST, self.dtype)

    @property
    def _feature_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.bf16_features else self.dtype

    def _dense_rows(self, lo: int, hi: int) -> Tensor:
        """CSR rows [lo, hi) as a [chunk_rows, D] block (tail rows zero),
        converted as the materialized build converts ``to_dense``."""
        m = self.shard_csr
        out = np.zeros((self.stream.chunk_rows, self.num_features), dtype=numpy_dtype(self.dtype))
        nz_lo, nz_hi = int(m.indptr[lo]), int(m.indptr[hi])
        rows = np.repeat(np.arange(hi - lo), np.diff(np.asarray(m.indptr[lo : hi + 1])))
        out[rows, m.indices[nz_lo:nz_hi]] = m.values[nz_lo:nz_hi]
        return torch.from_numpy(out).to(self._feature_dtype)

    def _iter_score_chunks(self) -> Iterator:
        cr = self.stream.chunk_rows
        for lo in range(0, self.num_samples, cr):
            hi = min(lo + cr, self.num_samples)
            yield (lo, hi), (self._dense_rows(lo, hi),)

    def _score_key(self) -> tuple:
        return ("stream_score", self.stream.chunk_rows, False)

    def score(self, state: Tensor) -> Tensor:
        out = torch.zeros(self.num_samples, dtype=self.dtype)
        # the host state goes up without a stream sync: a copy from
        # pageable memory is staged before the call returns
        # phl-ok: PHL007 a streaming fit refuses a mesh: its state is per-process
        state_dev = state.to(self.device, self.dtype, non_blocking=True)

        def run_fn(meta, dev):
            (block,) = dev
            self.programs.dispatch(self._score_key())
            return self.score_batch(LabeledBatch(block, None, None, None), state_dev)

        def sink_fn(meta, res):
            lo, hi = meta
            with obs.host_sync("stream.chunk_readback"):
                # phl-ok: PHL002 a chunk's read-back, once per chunk behind its compute
                out[lo:hi] = res[: hi - lo].to(_HOST)

        with obs.span("train.stream.fe_score", cat="stream", coordinate=self.feature_shard):
            run_stream(self._iter_score_chunks(), run_fn, sink_fn, telemetry=self.telemetry,
                       device=self.device, label="fe-score")
        return out

    def max_chunk_device_bytes(self) -> int:
        cr = self.stream.chunk_rows
        feat = torch.empty((), dtype=self._feature_dtype).element_size()
        item = torch.empty((), dtype=self.dtype).element_size()
        return cr * self.num_features * feat + cr * item

    def table_device_bytes(self) -> int:
        """The state and the normalization's factors and shifts, on the
        card for a whole score stream."""
        return 3 * self.num_features * torch.empty((), dtype=self.dtype).element_size()

    def train(self, residual_scores, state):
        raise StreamingModeError(
            "streaming fits require fixed-effect coordinates to be locked (the "
            "global L-BFGS cannot train bit-exactly from chunks); train the FE "
            "coordinate materialized, then stream with it locked"
        )

    def sweep_step(self, total, score, state):
        self.train(None, state)  # raises

    def precompile_specs(self, include_sweep: bool = True) -> list:
        """The score program only (a streaming fixed effect is locked),
        warmed on one zero [chunk_rows, D] block."""
        key = self._score_key()

        def warm_fn():
            self.programs.warm(key)
            # phl-ok: PHL007 a streaming fit refuses a mesh: its state is per-process
            state_dev = self.initial_state().to(self.device, non_blocking=True)
            block = torch.zeros((self.stream.chunk_rows, self.num_features),
                                dtype=self._feature_dtype)
            _warm_chunk(_Stager(self.device), self.telemetry, (block,), lambda dev: (
                self.score_batch(LabeledBatch(dev[0], None, None, None), state_dev),))

        return [(key, "stream_score", warm_fn)]

    def to_model(self, state: Tensor):
        if self.problem.config.variance_computation.value != "NONE":
            raise StreamingModeError(
                "streaming fits do not compute coefficient variances; set "
                "variance_computation=NONE"
            )
        # phl-ok: PHL007 a streaming fit refuses a mesh: its state is per-process
        return super().to_model(state.to(self.device))


# -- streaming random effect ----------------------------------------------------


@dataclasses.dataclass(eq=False)
class _HostBucket:
    """One size bucket in host memory, converted to the fit's dtype once
    (the values the card sees are those the materialized build places)."""

    features: Tensor  # [E, rows, d]
    labels: Tensor  # [E, rows]
    offsets: Tensor
    weights: Tensor
    sample_pos: Tensor  # [E, rows] int64, num_samples ⇒ padding
    score_feats: Tensor  # [M, d]
    score_slot: Tensor  # [M] int64
    score_pos: Tensor  # [M] int64, unique
    ec: int  # entity lanes per solve chunk

    @property
    def num_entities(self) -> int:
        return self.features.shape[0]

    @property
    def rows(self) -> int:
        return self.features.shape[1]

    @property
    def dim(self) -> int:
        return self.features.shape[2]


@dataclasses.dataclass(eq=False)
class StreamingRandomEffectCoordinate(RandomEffectCoordinate):
    """A random effect that trains by streaming entity-lane chunks of its
    host buckets through ``solve_lanes`` and scores by streaming flat
    score-row chunks through ``score_rows``. One sweep is two streams:
    the solve stream (host residual gather and fold → lane-batched solve
    on the card → coefficients written into the host table), then the
    score stream (host coefficient-row gather → row dot on the card →
    write into the host [N] score). States are lists of CPU tensors [E, d];
    ``device`` is where the chunks compute."""

    stream: StreamConfig = None
    telemetry: StreamTelemetry = None
    host_buckets: list = dataclasses.field(default_factory=list)

    @staticmethod
    def build_streaming(
        dataset: RandomEffectDataset,
        config,
        *,
        dtype: torch.dtype,
        device: torch.device,
        stream: StreamConfig,
        telemetry: StreamTelemetry,
    ) -> "StreamingRandomEffectCoordinate":
        def f(a):
            return torch.as_tensor(a).to(dtype=dtype)

        def i(a):
            return torch.as_tensor(a).to(dtype=torch.int64)

        host_buckets = []
        for b in dataset.buckets:
            rows = max(int(b.padded_samples), 1)
            # a bucket that fits in one chunk solves with exactly the
            # materialized [E, rows, d] batch (the module docstring)
            ec = min(max(1, stream.chunk_rows // rows), max(int(b.features.shape[0]), 1))
            host_buckets.append(_HostBucket(
                features=f(b.features), labels=f(b.labels), offsets=f(b.offsets),
                weights=f(b.weights), sample_pos=i(b.sample_pos),
                score_feats=f(b.score_feats), score_slot=i(b.score_slot),
                score_pos=i(b.score_pos), ec=ec,
            ))
        return StreamingRandomEffectCoordinate(
            config=config, dataset=dataset, device_buckets=[],
            problem_config=config.optimization.with_regularization_weight(
                config.regularization_weights[0]
            ),
            num_samples=dataset.num_samples, dtype=dtype, device=device,
            stream=stream, telemetry=telemetry, host_buckets=host_buckets,
        )

    def initial_state(self) -> list[Tensor]:
        return [torch.zeros((hb.num_entities, hb.dim), dtype=self.dtype)
                for hb in self.host_buckets]

    def place_state(self, state: list) -> list[Tensor]:
        return [w.detach().to(_HOST, self.dtype) for w in state]

    def single_chunk_buckets(self) -> list[bool]:
        """Per bucket: solved in one chunk, so with the materialized
        program's batch (the bit-parity class)."""
        return [hb.ec == hb.num_entities for hb in self.host_buckets]

    # -- the score stream ---------------------------------------------------

    def _iter_score_chunks(self, state: list) -> Iterator:
        mc = self.stream.chunk_rows
        for hb, coefs in zip(self.host_buckets, state):
            m = hb.score_feats.shape[0]
            for m0 in range(0, m, mc):
                real = min(mc, m - m0)
                feats = _pad_rows(hb.score_feats[m0 : m0 + real], mc)
                crows = _pad_rows(coefs[hb.score_slot[m0 : m0 + real]], mc)
                yield (hb.score_pos[m0 : m0 + real], real), (feats, crows)

    def score(self, state: list) -> Tensor:
        out = torch.zeros(self.num_samples, dtype=self.dtype)

        def run_fn(meta, dev):
            feats, crows = dev
            self.programs.dispatch(("stream_score", feats.shape[0], feats.shape[1], False))
            return score_rows(feats, crows)

        def sink_fn(meta, res):
            pos, real = meta
            # positions are unique: the write equals the device's
            with obs.host_sync("stream.chunk_readback"):
                # phl-ok: PHL002 a chunk's read-back, once per chunk behind its compute
                out[pos] = res[:real].to(_HOST)

        with obs.span("train.stream.re_score", cat="stream",
                      coordinate=self.config.random_effect_type):
            run_stream(self._iter_score_chunks(state), run_fn, sink_fn,
                       telemetry=self.telemetry, device=self.device, label="re-score")
        return out

    # -- the solve stream and the sweep step ---------------------------------

    def _iter_solve_chunks(self, state: list, res_pad: Tensor) -> Iterator:
        for bi, (hb, coefs) in enumerate(zip(self.host_buckets, state)):
            ec, e = hb.ec, hb.num_entities
            for e0 in range(0, e, ec):
                real = min(ec, e - e0)
                sl = slice(e0, e0 + real)
                offsets = fold_residual(hb.offsets[sl], hb.sample_pos[sl], res_pad)
                # padding lanes: no rows of weight, w0 = 0; they stay at 0
                yield (bi, e0, real), tuple(
                    _pad_rows(t, ec)
                    for t in (hb.features[sl], hb.labels[sl], offsets, hb.weights[sl], coefs[sl])
                )

    def sweep_step(self, total: Tensor, score: Tensor, state: list):
        residual = total - score
        res_pad = torch.cat([residual, residual.new_zeros(1)])
        new_state = [torch.empty_like(w) for w in state]
        sums = [0.0, 0.0]  # loss, squared gradient norm, in chunk order

        def run_fn(meta, dev):
            features, labels, offsets, weights, w0 = dev
            self.programs.dispatch(("stream_solve", *features.shape, False))
            res = solve_lanes(self.problem_config, features, labels, offsets, weights, w0)
            return res.x, res.value, res.gradient.to(torch.float32).square().sum(-1)

        def sink_fn(meta, out):
            bi, e0, real = meta
            host = []
            for t in out:
                with obs.host_sync("stream.chunk_readback"):
                    # phl-ok: PHL002 a chunk's read-back, once per chunk behind its compute
                    host.append(t[:real].to(_HOST))
            x, value, gsq = host
            new_state[bi][e0 : e0 + real] = x
            sums[0] += float(value.to(torch.float64).sum())
            sums[1] += float(gsq.to(torch.float64).sum())

        with obs.span("train.stream.re_solve", cat="stream",
                      coordinate=self.config.random_effect_type):
            n_chunks = run_stream(
                self._iter_solve_chunks(state, res_pad), run_fn, sink_fn,
                telemetry=self.telemetry, device=self.device, label="re-solve",
            )
        new_score = self.score(new_state)
        loss = float(np.float32(sums[0]))
        gnorm = float(np.sqrt(np.float32(sums[1])))
        finite = bool(np.isfinite(loss) and np.isfinite(gnorm)
                      and all(bool(torch.isfinite(w).all()) for w in new_state))
        health = {"loss": loss, "gnorm": gnorm, "finite": finite, "chunks": n_chunks}
        return new_state, new_score, residual + new_score, health

    def train(self, residual_scores, state):
        raise NotImplementedError(
            "a streaming random effect trains through sweep_step (the chunked solve "
            "stream); train() is the materialized coordinates' entry point"
        )

    def precompile_specs(self, include_sweep: bool = True) -> list:
        """One ``stream_solve`` key per distinct solve chunk shape and one
        ``stream_score`` key per distinct score chunk shape, deduplicated
        across buckets as JAX's are. A solve key warms on its bucket's
        first ``ec`` entity lanes with zero coefficients, a zero residual
        and the optimizer capped at one iteration (zero features would
        converge at iteration 0 and skip the line search); a score key on
        a zero chunk. Every key stages through one stager."""
        out, seen = [], set()
        mc = self.stream.chunk_rows
        stager = _Stager(self.device)
        for hb in self.host_buckets:
            key = ("stream_solve", hb.ec, hb.rows, hb.dim, False)
            if include_sweep and key not in seen:
                seen.add(key)
                out.append((key, "stream_solve", self._solve_warmer(key, hb, stager)))
            key = ("stream_score", mc, hb.dim, False)
            if key not in seen:
                seen.add(key)
                out.append((key, "stream_score", self._score_warmer(key, hb.dim, stager)))
        return out

    def _solve_warmer(self, key: tuple, hb: _HostBucket, stager: _Stager):
        def warm_fn():
            self.programs.warm(key)
            real = min(hb.ec, hb.num_entities)
            res_pad = torch.zeros(self.num_samples + 1, dtype=self.dtype)
            offsets = fold_residual(hb.offsets[:real], hb.sample_pos[:real], res_pad)
            w0 = torch.zeros((real, hb.dim), dtype=self.dtype)
            host = tuple(_pad_rows(t, hb.ec) for t in (
                hb.features[:real], hb.labels[:real], offsets, hb.weights[:real], w0))
            config = one_iteration(self.problem_config)

            def run_fn(dev):
                res = solve_lanes(config, *dev)
                return res.x, res.value, res.gradient.to(torch.float32).square().sum(-1)

            _warm_chunk(stager, self.telemetry, host, run_fn)
        return warm_fn

    def _score_warmer(self, key: tuple, dim: int, stager: _Stager):
        def warm_fn():
            self.programs.warm(key)
            zeros = torch.zeros((self.stream.chunk_rows, dim), dtype=self.dtype)
            _warm_chunk(stager, self.telemetry, (zeros, zeros.clone()),
                        lambda dev: (score_rows(*dev),))
        return warm_fn

    # -- accounting and export ----------------------------------------------------

    def max_chunk_device_bytes(self) -> int:
        """The device bytes of one chunk at most, inputs and the outputs
        held until its read-back: the unit of the residency bound."""
        item = torch.empty((), dtype=self.dtype).element_size()
        worst = 0
        for hb in self.host_buckets:
            solve_in = (hb.ec * hb.rows * hb.dim + 3 * hb.ec * hb.rows + hb.ec * hb.dim) * item
            solve_out = (hb.ec * hb.dim + hb.ec) * item + hb.ec * 4
            score = (2 * self.stream.chunk_rows * hb.dim + self.stream.chunk_rows) * item
            worst = max(worst, solve_in + solve_out, score)
        return worst

    def to_model(self, state: list) -> RandomEffectModel:
        if self.problem_config.variance_computation.value != "NONE":
            raise StreamingModeError(
                "streaming fits do not compute coefficient variances; set "
                "variance_computation=NONE"
            )
        buckets = tuple(
            BucketCoefficients(entity_ids=b.entity_ids, col_index=b.col_index,
                               coefficients=_to_host(coefs), variances=None)
            for b, coefs in zip(self.dataset.buckets, state)
        )
        return RandomEffectModel(
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard,
            task=self.problem_config.task,
            vocab=self.dataset.vocab,
            buckets=buckets,
            num_features=self.dataset.num_features,
            projection_matrix=self.dataset.projection_matrix,
        )
