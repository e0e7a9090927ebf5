"""GameScorer: score a GameModel on the device through an overlapped
streaming pipeline.

Counterpart of photon_tpu/game/scoring.GameScorer. The batch program is
the JAX package's (``_pack_random_effect``, ``_score_fn``,
``_host_batch``): each batch is assembled on the host at a fixed row
count; fixed effects gather their coefficients per ELL slot, a random
effect under a random projection gathers one projection row per nonzero
slot (x·P without densifying x), an index-mapped one gathers its columns
from the batch's zero-padded dense block, and MF adds ⟨u, v⟩. Each entity
table has a trailing zero row that unseen entities read.

:meth:`GameScorer.stream` is the pipeline: chunk decode (or a cache
replay) on a producer thread → host batch assembly → host-to-device copy
→ the score program → a deferred read-back → the caller's sink (the
sharded Avro writers). The producer does host work only; every CUDA call
stays on the consumer thread. The JAX package gets its overlap from XLA's
asynchronous dispatch; on the card the port builds it by hand:

- a batch is staged into page-locked host buffers (a ring of
  ``STAGING_SLOTS`` slots, reused per array shape; a slot is refilled
  only after the event recorded behind its last copy has fired) and
  copied on a copy stream of its own, which the compute stream waits on
  by event; every device tensor that crosses streams is
  ``record_stream``-ed onto the compute stream;
- batch i's scores are copied back into a page-locked host tensor behind
  an event, and that event is synchronized only after batch i+1 has been
  enqueued (the double buffer), so the host assembles and copies batch
  i+1 while the card scores batch i.

On ``device="cpu"`` the same code runs without streams or page-locked
memory. Host staging is bounded: at most ``MAX_STAGED_CHUNKS`` decoded
chunks on the producer side and two in the consumer. A watchdog turns a
dead producer into :class:`ProducerDiedError` and a hung one into
:class:`StreamStallError`; a transient failure of a batch re-stages and
re-dispatches it (``BATCH_RETRY_POLICY``). Stage walls (``queue``,
``decode``, ``assemble``, ``h2d``, ``dispatch``, ``pipeline``,
``readback``, ``write``) and end-to-end walls go into
:class:`StreamStats`.

Not carried (each raises NotImplementedError naming itself): the latency
SLO (``PHOTON_SLO_SPEC``), causal tracing (``PHOTON_TRACE``) and the
transfer sanitizer (``PHOTON_SANITIZE``), ROADMAP A5 with the obs spans,
counters and flight recorder, whose numbers stay in ``StreamStats``; and
``precompile`` / ``aot_executables`` (ROADMAP A8: the port has no compile
step). ``PHOTON_SCORE_DONATION`` is an XLA knob and is dropped.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from photon_tpu_torch.game.data import (
    GameData,
    _ceil_pow2,
    entity_row_indices,
    pad_game_data,
    slice_game_data,
)
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.types import numpy_dtype, resolve_device
from photon_tpu_torch.util import faults
from photon_tpu_torch.util.retry import RetryPolicy, is_transient, retry_call

logger = logging.getLogger(__name__)

DEFAULT_BATCH_ROWS = 8192
#: widest index-mapped RE feature shard the scorer densifies per batch
DENSE_COLS_MAX = 4096
#: decoded chunks staged on the producer side at most: one in the
#: hand-off queue and the one the producer holds while it waits; the
#: consumer holds two more (the batch being assembled and the one whose
#: read-back is deferred), so at most MAX_STAGED_CHUNKS + 2 are live
MAX_STAGED_CHUNKS = 2
#: seconds the consumer waits for the next chunk before calling the
#: producer hung (``PHOTON_STREAM_WATCHDOG_S``; 0 disables)
DEFAULT_WATCHDOG_S = 300.0
#: per-batch transient retry: the chunk is still on the host, so a retry
#: re-stages and re-dispatches the same batch
BATCH_RETRY_POLICY = RetryPolicy(attempts=3, base_s=0.5, cap_s=15.0)
#: page-locked staging slots on the card: the batch being assembled, the
#: one being copied and the one being scored each hold one
STAGING_SLOTS = 3

#: environment overrides of the JAX scorer's obs layers, not ported
_UNPORTED_ENV = (
    ("PHOTON_SLO_SPEC", "ROADMAP A5: obs.slo, the latency SLO plane"),
    ("PHOTON_TRACE", "ROADMAP A5: obs.causal, causal tracing"),
    ("PHOTON_SANITIZE", "ROADMAP A5: the transfer sanitizer"),
)


def score_batch_rows(config_value: int | None = None) -> int:
    """Rows per scoring batch: ``PHOTON_SCORE_BATCH_ROWS`` env > the
    given value > DEFAULT_BATCH_ROWS."""
    env = os.environ.get("PHOTON_SCORE_BATCH_ROWS", "").strip()
    if env:
        v = int(env)
    elif config_value is not None:
        v = int(config_value)
    else:
        return DEFAULT_BATCH_ROWS
    if v < 1:
        raise ValueError(f"score batch rows must be >= 1, got {v}")
    return v


def stream_watchdog_s() -> float:
    """Producer-watchdog seconds: ``PHOTON_STREAM_WATCHDOG_S`` env >
    DEFAULT_WATCHDOG_S; 0 disables."""
    env = os.environ.get("PHOTON_STREAM_WATCHDOG_S", "").strip()
    if not env:
        return DEFAULT_WATCHDOG_S
    v = float(env)
    if v < 0:
        raise ValueError(f"stream watchdog must be >= 0, got {v}")
    return v


class UnsupportedModelLayout(ValueError):
    """A model layout the device scorer cannot express (an index-mapped
    random effect on a shard wider than the dense gather limit, or an
    unknown coordinate model); the host path ``GameModel.score`` can."""


class StreamError(RuntimeError):
    """A failure of the streaming pipeline that the monolithic path does
    not share: what the scoring driver's opt-in degrade escape catches."""


class ProducerDiedError(StreamError):
    """The producer thread died without handing over a result or an
    error; the watchdog turns the consumer's endless wait into this."""


class StreamStallError(StreamError):
    """The producer is alive but handed over nothing for the whole
    watchdog window."""


@dataclasses.dataclass(frozen=True)
class _FixedSpec:
    cid: str
    shard: str


@dataclasses.dataclass(frozen=True)
class _RandomSpec:
    cid: str
    shard: str
    tag: str
    projected: bool
    num_entities: int


@dataclasses.dataclass(frozen=True)
class _MFSpec:
    cid: str
    row_tag: str
    col_tag: str
    num_rows: int
    num_cols: int


def _percentiles(walls, ps) -> dict:
    arr = np.asarray(walls)
    return {f"p{p:g}": round(float(np.percentile(arr, p)), 6) for p in ps}


@dataclasses.dataclass
class StreamStats:
    """Counts and walls of one streaming run."""

    batches: int = 0
    samples: int = 0
    padded_rows: int = 0
    max_staged_chunks: int = 0
    #: transient per-batch retries spent
    batch_retries: int = 0
    #: per-batch dispatch → read-back walls
    batch_walls_s: list = dataclasses.field(default_factory=list)
    #: per-batch end-to-end walls: decode start → scores written
    e2e_walls_s: list = dataclasses.field(default_factory=list)
    #: per-stage walls, one list per stage
    stage_walls_s: dict = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0

    def latency_percentiles(self) -> dict:
        """p50/p95/p99 warm batch latency (batch 0 left out)."""
        walls = self.batch_walls_s[1:]
        return _percentiles(walls, (50, 95, 99)) if walls else {}

    def e2e_percentiles(self) -> dict:
        """p50/p90/p99/p99.9, mean, max and count of the end-to-end batch
        latency, every batch."""
        walls = self.e2e_walls_s
        if not walls:
            return {}
        arr = np.asarray(walls)
        return {**_percentiles(arr, (50, 90, 99, 99.9)), "mean": round(float(arr.mean()), 6),
                "max": round(float(arr.max()), 6), "count": len(walls)}

    def stage_percentiles(self) -> dict:
        """p50/p90/p99 per stage: the latency waterfall of the summary."""
        return {stage: _percentiles(walls, (50, 90, 99))
                for stage, walls in self.stage_walls_s.items() if walls}


@dataclasses.dataclass
class StreamResult:
    """What :meth:`GameScorer.stream` returns."""

    scores: np.ndarray
    stats: StreamStats


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class _ChunkItem:
    """A decoded chunk with its stamps (``time.perf_counter``): ``birth_t``
    when its decode began, ``decoded_t`` when it ended."""

    chunk: GameData
    birth_t: float
    decode_s: float
    decoded_t: float


class _StageCounter:
    """Staged-chunk count of one stream (not scorer state: a producer
    orphaned by a failed stream touches only its own stream's count)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.value = 0


_DONE = object()


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of a batch's dicts and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


class GameScorer:
    """Scores = Σ coordinate margins + offsets, computed on ``device``."""

    def __init__(
        self,
        model: GameModel,
        *,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.float32,
        batch_rows: int | None = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = model
        self.batch_rows = score_batch_rows(batch_rows)
        self.watchdog_s = stream_watchdog_s()
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            #: per slot: (path, shape, dtype) → page-locked host tensor
            self._pinned: list[dict] = [{} for _ in range(STAGING_SLOTS)]
            #: per slot: the event behind the last copy that read it
            self._copied: list[torch.cuda.Event | None] = [None] * STAGING_SLOTS
            self._slot = 0
        self._fixed: list[_FixedSpec] = []
        self._random: list[_RandomSpec] = []
        self._mf: list[_MFSpec] = []
        self._ell_shards: dict[str, int] = {}
        self._dense_shards: dict[str, int] = {}
        self._params: dict = {"fe": {}, "re": {}, "mf": {}}
        for cid, cm in model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                w = np.asarray(cm.coefficients.means)
                self._fixed.append(_FixedSpec(cid=cid, shard=cm.feature_shard))
                self._ell_shards.setdefault(cm.feature_shard, len(w))
                self._params["fe"][cid] = self._tensor(w)
            elif isinstance(cm, RandomEffectModel):
                self._params["re"][cid] = self._pack_random_effect(cid, cm)
            elif isinstance(cm, MatrixFactorizationModel):
                k = cm.num_factors
                self._mf.append(
                    _MFSpec(
                        cid=cid, row_tag=cm.row_entity_type, col_tag=cm.col_entity_type,
                        num_rows=len(cm.row_vocab), num_cols=len(cm.col_vocab),
                    )
                )
                self._params["mf"][cid] = {
                    "u": self._tensor(np.concatenate([cm.row_factors, np.zeros((1, k))])),
                    "v": self._tensor(np.concatenate([cm.col_factors, np.zeros((1, k))])),
                }
            else:
                raise UnsupportedModelLayout(f"unknown coordinate model for {cid!r}")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.require(np.asarray(a), requirements="W")).to(
            device=self.device, dtype=dtype or self.dtype
        )

    def _pack_random_effect(self, cid: str, cm: RandomEffectModel) -> dict:
        """Per-entity coefficients in their projected space; row E (zeros)
        scores unseen entities as 0. Projected: the [D, k] matrix rides
        along. Index-mapped: the column map back to the shard, invalid slots
        pointing at the batch block's appended zero column."""
        e_n = len(cm.vocab)
        if cm.projection_matrix is not None:
            k = cm.projection_matrix.shape[1]
            coef = np.zeros((e_n + 1, k))
            for b in cm.buckets:
                coef[np.asarray(b.entity_ids)] = np.asarray(b.coefficients)[:, :k]
            self._random.append(
                _RandomSpec(cid=cid, shard=cm.feature_shard, tag=cm.random_effect_type,
                            projected=True, num_entities=e_n)
            )
            self._ell_shards.setdefault(cm.feature_shard, cm.num_features)
            return {"coef": self._tensor(coef), "proj": self._tensor(cm.projection_matrix)}
        d_shard = cm.num_features
        if d_shard > DENSE_COLS_MAX:
            raise UnsupportedModelLayout(
                f"random-effect coordinate {cid!r} scores on shard "
                f"{cm.feature_shard!r} with {d_shard} columns, wider than the "
                f"dense gather limit {DENSE_COLS_MAX}; "
                "score it with GameModel.score on the host"
            )
        d_pack = max((int(np.asarray(b.col_index).shape[1]) for b in cm.buckets), default=1)
        coef = np.zeros((e_n + 1, d_pack))
        col = np.full((e_n + 1, d_pack), d_shard, dtype=np.int64)
        for b in cm.buckets:
            ids = np.asarray(b.entity_ids)
            ci = np.asarray(b.col_index)
            coef[ids, : ci.shape[1]] = np.asarray(b.coefficients)
            col[ids, : ci.shape[1]] = np.where(ci >= 0, ci, d_shard)
        self._random.append(
            _RandomSpec(cid=cid, shard=cm.feature_shard, tag=cm.random_effect_type,
                        projected=False, num_entities=e_n)
        )
        self._dense_shards.setdefault(cm.feature_shard, d_shard)
        return {"coef": self._tensor(coef), "col": self._tensor(col, torch.int64)}

    def _score_fn(self, batch: dict) -> torch.Tensor:
        """Total margin + offsets for one padded batch, all coordinates."""
        total = batch["offsets"]
        for s in self._fixed:
            idx, val = batch["ell"][s.shard]
            total = total + (val * self._params["fe"][s.cid][idx]).sum(-1)
        for s in self._random:
            tab = self._params["re"][s.cid]
            e = batch["eidx"][s.cid]
            coef = tab["coef"][e]
            if s.projected:
                idx, val = batch["ell"][s.shard]
                # x·P by one P row per nonzero slot (padding slots hold 0)
                x_eff = torch.einsum("bs,bsk->bk", val, tab["proj"][idx])
                total = total + (coef * x_eff).sum(-1)
            else:
                xg = torch.gather(batch["dense"][s.shard], 1, tab["col"][e])
                total = total + (coef * xg).sum(-1)
        for s in self._mf:
            tabs = self._params["mf"][s.cid]
            ri, ci = batch["mf"][s.cid]
            total = total + (tabs["u"][ri] * tabs["v"][ci]).sum(-1)
        return total

    def _host_batch(self, chunk: GameData) -> dict:
        """Pad a chunk to ``batch_rows`` and assemble the numpy batch: ELL
        blocks at power-of-two widths, dense blocks with an appended zero
        column, entity table rows."""
        if chunk.num_samples > self.batch_rows:
            raise ValueError(
                f"chunk has {chunk.num_samples} rows > batch_rows={self.batch_rows}"
            )
        padded = pad_game_data(chunk, self.batch_rows)
        np_dtype = numpy_dtype(self.dtype)
        batch: dict = {"offsets": padded.offsets.astype(np_dtype), "ell": {},
                       "dense": {}, "eidx": {}, "mf": {}}
        for shard, width in self._ell_shards.items():
            m = padded.feature_shards[shard]
            if m.num_cols != width:
                raise ValueError(
                    f"shard {shard!r} has {m.num_cols} columns; the model has {width}"
                )
            k_raw = int(np.max(np.diff(m.indptr))) if m.num_rows else 1
            idx, val = m.to_ell(dtype=np_dtype, nnz_pad_multiple=_ceil_pow2(max(k_raw, 1)))
            batch["ell"][shard] = (idx.astype(np.int64), val)
        for shard, width in self._dense_shards.items():
            m = padded.feature_shards[shard]
            if m.num_cols != width:
                raise ValueError(
                    f"shard {shard!r} has {m.num_cols} columns; the model has {width}"
                )
            x = np.zeros((self.batch_rows, width + 1), dtype=np_dtype)
            rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
            x[rows, m.indices] = m.values
            batch["dense"][shard] = x
        for s in self._random:
            cm = self.model.coordinates[s.cid]
            batch["eidx"][s.cid] = entity_row_indices(
                cm.entity_row_index, padded.id_tags[s.tag], s.num_entities
            )
        for s in self._mf:
            cm = self.model.coordinates[s.cid]
            batch["mf"][s.cid] = (
                entity_row_indices(cm.row_index, padded.id_tags[s.row_tag], s.num_rows),
                entity_row_indices(cm.col_index, padded.id_tags[s.col_tag], s.num_cols),
            )
        return batch

    def precompile(self, ell_widths=None) -> dict:
        raise NotImplementedError(
            "GameScorer.precompile is not ported to photon_tpu_torch yet (ROADMAP A8: "
            "warm-up of the sweep and score programs; the port has no compile step)"
        )

    def aot_executables(self) -> dict:
        raise NotImplementedError(
            "GameScorer.aot_executables is not ported to photon_tpu_torch yet (ROADMAP A8: "
            "warm-up of the sweep and score programs; the port has no compile step)"
        )

    # -- host → device ------------------------------------------------------

    def _pinned_buffer(self, slot: int, path: tuple, a: np.ndarray) -> torch.Tensor:
        """The slot's page-locked buffer for the array at ``path`` of this
        shape and dtype (batches share a few shapes: the ELL widths are
        powers of two)."""
        key = (path, a.shape, a.dtype.str)
        buf = self._pinned[slot].get(key)
        if buf is None:
            buf = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
            self._pinned[slot][key] = buf
        return buf

    def _stage(self, host_batch: dict) -> dict:
        """The batch on the device. On the card: through the next slot's
        page-locked buffers, copied on the copy stream, with the compute
        stream waiting on their event."""
        if self.device.type != "cuda":
            return _tree_map(lambda _, a: torch.from_numpy(a), host_batch)
        slot = self._slot
        self._slot = (slot + 1) % STAGING_SLOTS
        copied = self._copied[slot]
        if copied is not None:
            copied.synchronize()  # the last copy out of this slot is done

        def fill(path, a):
            buf = self._pinned_buffer(slot, path, a)
            np.copyto(buf.numpy(), a)
            return buf

        pinned = _tree_map(fill, host_batch)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = _tree_map(lambda _, b: b.to(self.device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._copied[slot] = event
        compute.wait_event(event)
        _tree_map(lambda _, t: t.record_stream(compute), dev)
        return dev

    def _enqueue(self, batch_dev: dict, rows: int):
        """Enqueue the score program and, on the card, the copy of its
        first ``rows`` scores into a page-locked host tensor behind an
        event (PyTorch's host allocator keeps that tensor's memory until
        the copy is done). Returns what :meth:`_read_back` takes."""
        total = self._score_fn(batch_dev)[:rows]
        if self.device.type != "cuda":
            return total, None
        out = torch.empty(rows, dtype=self.dtype, pin_memory=True)
        out.copy_(total, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return out, event

    @staticmethod
    def _read_back(enqueued) -> np.ndarray:
        out, event = enqueued
        if event is not None:
            event.synchronize()  # the scores are in the host buffer now
        return out.numpy().astype(np.float64)

    # -- streaming pipeline -------------------------------------------------

    def _produce(self, chunk_iter: Iterator, q: queue.Queue, stats: StreamStats,
                 staged: _StageCounter, stop: threading.Event) -> None:
        """Producer thread: pull (decode) chunks and hand them over
        through the bounded queue; host work only. ``stop`` is the
        consumer's abort signal, so a failed consumer never leaves this
        thread blocked on a full queue."""
        # outside the failure hand-off below: an ``error`` here kills the
        # thread with no sentinel (what the watchdog must turn into
        # ProducerDiedError); a ``stall`` is the hung producer
        faults.fault_point("scoring.producer")

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            while not stop.is_set():
                t_pull = time.perf_counter()
                # inside the hand-off: a decode fault reaches the consumer
                faults.fault_point("scoring.chunk")
                chunk = next(chunk_iter, _DONE)
                t_decoded = time.perf_counter()
                if chunk is _DONE:
                    put(_DONE)
                    return
                item = _ChunkItem(chunk=chunk, birth_t=t_pull, decode_s=t_decoded - t_pull,
                                  decoded_t=t_decoded)
                with staged.lock:
                    staged.value += 1
                    stats.max_staged_chunks = max(stats.max_staged_chunks, staged.value)
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            put(_Failure(e))

    def _next_item(self, q: queue.Queue, producer: threading.Thread):
        """The watchdog-guarded hand-off: a dead producer with an empty
        queue is ProducerDiedError, a silent one past the watchdog
        StreamStallError."""
        waited = 0.0
        poll = 0.5 if self.watchdog_s == 0 else min(0.5, self.watchdog_s)
        while True:
            try:
                return q.get(timeout=poll)
            except queue.Empty:
                pass
            if not producer.is_alive():
                try:  # it may have put and exited between the two checks
                    return q.get_nowait()
                except queue.Empty:
                    raise ProducerDiedError(
                        "score-decode producer thread died without reporting a result "
                        "or an error; the stream cannot make progress"
                    ) from None
            waited += poll
            if self.watchdog_s and waited >= self.watchdog_s:
                raise StreamStallError(
                    f"score-decode producer produced nothing for {waited:.0f}s (watchdog "
                    f"PHOTON_STREAM_WATCHDOG_S={self.watchdog_s:g}); treating the stream "
                    "as hung"
                )

    def stream(
        self,
        chunks: Iterable[GameData],
        *,
        on_batch: Callable[[GameData, np.ndarray], None] | None = None,
    ) -> StreamResult:
        """Run the pipeline over ``chunks`` (each at most ``batch_rows``
        rows). ``on_batch(chunk, scores)`` is called in input order as each
        batch's scores arrive (float64, padding dropped); the result holds
        them concatenated."""
        for var, item in _UNPORTED_ENV:
            value = os.environ.get(var, "").strip()
            if value not in ("", "0"):
                raise NotImplementedError(
                    f"{var}={value!r} is not ported to photon_tpu_torch yet ({item})"
                )
        stats = StreamStats()
        collected: list[np.ndarray] = []
        q: queue.Queue = queue.Queue(maxsize=MAX_STAGED_CHUNKS - 1)
        stop = threading.Event()
        staged = _StageCounter()
        t_start = time.perf_counter()
        producer = threading.Thread(
            target=self._produce, args=(iter(chunks), q, stats, staged, stop),
            name="score-decode", daemon=True,
        )

        def finish(pending) -> None:
            enqueued, item, t_dispatch, stages, t_enqueued = pending
            chunk = item.chunk
            t_r0 = time.perf_counter()
            # the double-buffer hold: this batch waited for the next one
            # to be enqueued before its read-back
            stages["pipeline"] = t_r0 - t_enqueued
            scores = self._read_back(enqueued)
            stages["readback"] = time.perf_counter() - t_r0
            stats.batch_walls_s.append(time.perf_counter() - t_dispatch)
            stats.batches += 1
            stats.samples += chunk.num_samples
            collected.append(scores)
            if on_batch is not None:
                t_w0 = time.perf_counter()
                on_batch(chunk, scores)
                stages["write"] = time.perf_counter() - t_w0
            stats.e2e_walls_s.append(time.perf_counter() - item.birth_t)
            for stage, sec in stages.items():
                stats.stage_walls_s.setdefault(stage, []).append(sec)

        producer.start()
        pending = None
        failure: BaseException | None = None
        try:
            while True:
                item = self._next_item(q, producer)
                if isinstance(item, _Failure):
                    failure = item.exc
                    break
                if item is _DONE:
                    break
                with staged.lock:
                    staged.value -= 1
                chunk = item.chunk
                t_pickup = time.perf_counter()
                stages = {"decode": item.decode_s, "queue": t_pickup - item.decoded_t}
                host_batch = self._host_batch(chunk)
                stats.padded_rows += self.batch_rows - chunk.num_samples
                stages["assemble"] = time.perf_counter() - t_pickup
                tries = 0
                h2d = [0.0]

                def run_batch(host_batch=host_batch, rows=chunk.num_samples, h2d=h2d):
                    nonlocal tries
                    tries += 1
                    faults.fault_point("scoring.batch")
                    t_h0 = time.perf_counter()
                    batch_dev = self._stage(host_batch)
                    h2d[0] += time.perf_counter() - t_h0
                    return self._enqueue(batch_dev, rows)

                t_dispatch = time.perf_counter()
                enqueued = retry_call(
                    run_batch, policy=BATCH_RETRY_POLICY, classify=is_transient,
                    label="score_batch",
                )
                stages["h2d"] = h2d[0]
                stages["dispatch"] = time.perf_counter() - t_dispatch - h2d[0]
                stats.batch_retries += tries - 1
                # double buffer: batch i is read back only once batch i+1
                # is enqueued
                if pending is not None:
                    finish(pending)
                pending = (enqueued, item, t_dispatch, stages, time.perf_counter())
            if pending is not None and failure is None:
                finish(pending)
        finally:
            # a consumer-side failure must not leave the producer blocked
            # on a full queue holding decoded chunks: signal, drain, reap
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            producer.join(timeout=5.0)
            if producer.is_alive():
                logger.warning("score-decode producer still draining after 5 s; detaching")
        if failure is not None:
            raise failure
        stats.wall_s = time.perf_counter() - t_start
        scores = np.concatenate(collected) if collected else np.zeros(0)
        return StreamResult(scores=scores, stats=stats)

    def score_data(self, data: GameData) -> np.ndarray:
        """Scores (margins + offsets, float64) of every row of ``data``,
        through the streaming pipeline in chunks of ``batch_rows``."""
        n = data.num_samples

        def gen():
            for lo in range(0, n, self.batch_rows):
                yield slice_game_data(data, lo, min(lo + self.batch_rows, n))

        return self.stream(gen()).scores
