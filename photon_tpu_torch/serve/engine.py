"""The persistent serving loop: micro-batch, dispatch, double-buffer.

Counterpart of photon_tpu/serve/engine.py. One consumer thread owns the
card. Each iteration it (1) applies any pending hot swap, the only place a
flip can happen, so a flip is always BETWEEN dispatches; (2) pops a
same-tenant micro-batch from the admission queue; (3) packs the requests
into the tenant's fixed batch shape (``concat_game_data`` and the scorer's
own padding), stages it through the scorer's page-locked slots on its
copy stream and enqueues the score program (``GameScorer._stage`` /
``_dispatch``) under the streaming scorer's retry policy; (4) reads back
the PREVIOUS batch: batch i's read-back waits until batch i+1 is enqueued
(or an idle tick), as in ``GameScorer.stream``, so the host assembles and
copies batch i+1 while the card scores batch i.

The drain protocol rides the registry's leases: a batch takes its scorer
at dispatch and releases it after its read-back's event has fired, so a
batch in flight finishes on the OLD tables across a flip and the old
buffer is dropped when the last old-model batch retires.

Staging under the hold: the engine keeps one batch pending while it
stages the next, and a retry stages again. Each ``_stage`` takes the next
of the scorer's ``STAGING_SLOTS`` slots and first waits for the event
behind that slot's last copy, so a slot is never refilled before its copy
has landed, however many stagings a retry adds.

Failure policy (everything answered, nothing dropped): a request whose
deadline runs out in the queue is shed by the queue; a batch whose
dispatch fails for good answers EVERY one of its futures with the error
(``serve.dispatch_failures``) and the loop keeps serving; a transient
failure retries in place (``BATCH_RETRY_POLICY``, the ``serve.dispatch``
fault point inside it).

Each answered request's end-to-end wall (arrival → answer) feeds
``slo.observe_batch`` with its batch's stage walls. ``compile_watch``
brackets the traffic window: ``stats.compiles["backend_compiles"]`` must
read 0 once serving starts, apart from swap-candidate builds.
``PHOTON_SANITIZE=transfers`` runs the loop with host syncs raising; the
staging slot's reuse wait and the read-back are the sanctioned syncs.

Causal tracing (obs/causal.py, ``PHOTON_TRACE``): each request's trace,
minted at admission, joins ONE ``serve.batch`` group per micro-batch (the
fan-in). The group is active on this thread over the dispatch window, so
an injected ``serve.dispatch`` fault lands in the batch; its slices
(``serve.assemble``, ``serve.h2d``, ``serve.dispatch``,
``serve.pipeline``, ``serve.readback``) are recorded once per batch from
the walls the stages already measured. Every member's flow steps into the
assemble slice and finishes inside the read-back slice, and an applied
swap is a global ``serve.swap`` instant.
"""
from __future__ import annotations

import logging
import threading
import time

from photon_tpu_torch import obs
from photon_tpu_torch.game.data import concat_game_data
from photon_tpu_torch.game.scoring import BATCH_RETRY_POLICY, StreamStats
from photon_tpu_torch.obs import causal, slo
from photon_tpu_torch.serve.admission import AdmissionQueue, ServeRequest
from photon_tpu_torch.serve.registry import ModelRegistry
from photon_tpu_torch.util import compile_watch, faults
from photon_tpu_torch.util.retry import is_transient, retry_call
from photon_tpu_torch.util.sanitize import transfer_sanitizer

__all__ = ["SERVE_STAGES", "ServingEngine"]

logger = logging.getLogger(__name__)

#: the fixed serving-stage enum, the only keys ``serve.stage_seconds.*``
#: histograms are emitted under (anything else folds into ``other``)
SERVE_STAGES = ("queue", "assemble", "h2d", "dispatch", "pipeline", "readback", "other")


class _Pending:
    """One dispatched batch whose read-back is deferred."""

    __slots__ = ("requests", "tenant", "scorer", "enqueued", "rows", "t_dispatch", "stages",
                 "t_enqueued", "group")

    def __init__(self, requests, tenant, scorer, enqueued, rows, t_dispatch, stages,
                 t_enqueued, group):
        self.requests = requests
        self.tenant = tenant
        self.scorer = scorer
        self.enqueued = enqueued
        self.rows = rows
        self.t_dispatch = t_dispatch
        self.stages = stages
        self.t_enqueued = t_enqueued
        self.group = group


class ServingEngine:
    """The always-on consumer loop over one card's admission queue."""

    def __init__(self, registry: ModelRegistry, queue: AdmissionQueue, *, batch_rows: int,
                 poll_s: float = 0.25):
        self.registry = registry
        self.queue = queue
        self.batch_rows = int(batch_rows)
        self.poll_s = float(poll_s)
        self.stats = StreamStats()
        #: the most recent applied flip: tenant, requests in flight at it,
        #: its wall, and how many rows were answered before it
        self.last_swap: dict | None = None
        self._thread: threading.Thread | None = None
        self._cw_start = None
        self._failure: BaseException | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("serving engine already started")
        causal.ensure_from_env()
        slo.ensure_from_env()
        compile_watch.install()
        self._cw_start = compile_watch.snapshot()
        # phl-ok: PHL003 engine-scoped thread: stop() closes the queue, joins, and re-raises loop failures; every owner calls it
        self._thread = threading.Thread(target=self._run, name="serve-engine", daemon=True)
        self._thread.start()
        obs.instant("serve.engine_started", cat="lifecycle")

    def stop(self, timeout: float = 60.0) -> StreamStats:
        """Close admissions, drain what is queued, join the loop. Queued
        requests are answered (or deadline-shed), never dropped."""
        self.queue.close()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(f"serve-engine thread did not drain within {timeout:g}s")
            self._thread = None
        if self._failure is not None:
            raise self._failure
        return self.stats

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- the loop -----------------------------------------------------------

    def _run(self) -> None:
        pending: _Pending | None = None
        try:
            obs.memory.census("serve_start")
            with transfer_sanitizer("serve.engine", self.registry.device):
                while True:
                    self._apply_swaps()
                    batch = self.queue.next_batch(self.batch_rows, timeout=self.poll_s)
                    if batch is None:
                        # idle tick: retire the held read-back rather than
                        # park a served batch behind traffic that may not come
                        if pending is not None:
                            self._finish(pending)
                            pending = None
                        continue
                    if not batch:
                        break  # closed and drained
                    current = self._dispatch_batch(batch)
                    # double buffer: batch i is read back after batch i+1
                    # is enqueued
                    if pending is not None:
                        self._finish(pending)
                    pending = current
                if pending is not None:
                    self._finish(pending)
                    pending = None
        except BaseException as exc:  # reported through stop()
            self._failure = exc
            logger.exception("serve-engine loop died")
            if pending is not None:
                self._resolve_error(pending.requests, exc)
                self.registry.release(pending.tenant, pending.scorer)
        finally:
            self.stats.shed = self.queue.shed_count
            if self._cw_start is not None:
                self.stats.compiles = compile_watch.delta(self._cw_start)
            obs.memory.census("serve_end")

    def _apply_swaps(self) -> None:
        """Apply every staged swap; only this thread calls it, so a flip
        always falls between dispatches."""
        for tenant in self.registry.tenants():
            if not self.registry.has_pending_swap(tenant):
                continue
            in_flight = self.registry.in_flight(tenant)
            t0 = time.perf_counter()
            if self.registry.apply_pending_swap(tenant):
                # a global instant: the flip in the victims' timeline
                causal.mark("serve.swap", tenant=tenant, in_flight_at_flip=in_flight)
                self.last_swap = {
                    "tenant": tenant,
                    "in_flight_at_flip": in_flight,
                    "flip_wall_s": round(time.perf_counter() - t0, 6),
                    "requests_before_flip": self.stats.samples,
                }

    @staticmethod
    def _resolve_error(requests: list[ServeRequest], exc) -> None:
        for req in requests:
            if not req.future.done():
                if req.trace is not None:
                    req.trace.instant("serve.error", error=type(exc).__name__)
                    req.trace.finish("error")
                req.future.set_exception(exc)

    def _dispatch_batch(self, batch: list[ServeRequest]) -> _Pending | None:
        tenant = batch[0].tenant
        t_pickup = time.perf_counter()
        stages = {"queue": t_pickup - batch[0].arrival_t}
        # the fan-in: N request traces join one group whose slices are
        # recorded once and referenced by every member
        group = causal.group("serve.batch", [r.trace for r in batch], tenant=tenant,
                             requests=len(batch))
        try:
            scorer = self.registry.acquire(tenant)
        except KeyError as exc:
            # an unknown tenant: answered with the typed error, loop goes on
            obs.counter("serve.dispatch_failures")
            self._resolve_error(batch, exc)
            return None
        try:
            with obs.span("serve.assemble", tenant=tenant, requests=len(batch)):
                packed = (concat_game_data([r.chunk for r in batch]) if len(batch) > 1
                          else batch[0].chunk)
                host_batch = scorer._host_batch(packed)
                key = scorer._shape_key(host_batch)
                self.stats.padded_rows += scorer.batch_rows - packed.num_samples
            stages["assemble"] = time.perf_counter() - t_pickup
            group.event("serve.assemble", t_pickup, stages["assemble"], tenant=tenant,
                        requests=len(batch), rows=packed.num_samples)
            for req in batch:
                if req.trace is not None:
                    # the flow steps INTO the batch at the assemble slice
                    req.trace.flow("t", t_pickup)
            tries = 0
            h2d = [0.0]

            def run_batch():
                nonlocal tries
                tries += 1
                # a transient fault retries THIS batch in place; any other
                # answers its futures below
                faults.fault_point("serve.dispatch")
                t_h0 = time.perf_counter()
                with obs.span("serve.h2d"):
                    batch_dev = scorer._stage(host_batch)
                    obs.memory.count_h2d(obs.memory.tree_device_bytes(batch_dev))
                h2d[0] += time.perf_counter() - t_h0
                return scorer._dispatch(batch_dev, key, packed.num_samples)

            t_dispatch = time.perf_counter()
            # the group is active over the dispatch window: an injected
            # serve.dispatch fault lands in the batch
            with group.active():
                enqueued = retry_call(run_batch, policy=BATCH_RETRY_POLICY,
                                      classify=is_transient, label="serve_batch")
            stages["h2d"] = h2d[0]
            stages["dispatch"] = (time.perf_counter() - t_dispatch) - h2d[0]
            # H2D then dispatch, back to back from the dispatch stamp
            group.event("serve.h2d", t_dispatch, stages["h2d"])
            group.event("serve.dispatch", t_dispatch + stages["h2d"], stages["dispatch"],
                        tries=tries)
            if tries > 1:
                self.stats.batch_retries += tries - 1
                obs.counter("serve.batch_retries", tries - 1)
        except Exception as exc:
            # a poisoned batch: every request answered with the error, the
            # lease retired, the engine keeps serving
            obs.counter("serve.dispatch_failures")
            self._resolve_error(batch, exc)
            self.registry.release(tenant, scorer)
            return None
        return _Pending(requests=batch, tenant=tenant, scorer=scorer, enqueued=enqueued,
                        rows=packed.num_samples, t_dispatch=t_dispatch, stages=stages,
                        t_enqueued=time.perf_counter(), group=group)

    def _finish(self, pending: _Pending | None) -> None:
        if pending is None:
            return
        stages = pending.stages
        t_r0 = time.perf_counter()
        stages["pipeline"] = t_r0 - pending.t_enqueued
        try:
            with obs.span("serve.readback", rows=pending.rows):
                obs.memory.count_d2h(pending.enqueued[0].nbytes)
                scores = pending.scorer._read_back(pending.enqueued)
        except Exception as exc:
            obs.counter("serve.dispatch_failures")
            self._resolve_error(pending.requests, exc)
            self.registry.release(pending.tenant, pending.scorer)
            return
        stages["readback"] = time.perf_counter() - t_r0
        pending.group.event("serve.pipeline", pending.t_enqueued, stages["pipeline"])
        pending.group.event("serve.readback", t_r0, stages["readback"], rows=pending.rows)
        wall = time.perf_counter() - pending.t_dispatch
        if not self.stats.batch_walls_s and self._cw_start is not None:
            self.stats.compiles_first_batch = compile_watch.delta(self._cw_start)
        self.stats.batch_walls_s.append(wall)
        self.stats.batches += 1
        obs.counter("serve.batches")
        obs.histogram("serve.batch_seconds", wall)
        for stage, sec in stages.items():
            self.stats.stage_walls_s.setdefault(stage, []).append(sec)
            obs.histogram(f"serve.stage_seconds.{stage if stage in SERVE_STAGES else 'other'}",
                          sec)
        # split the packed scores back out and close each request's
        # latency lifecycle against the armed SLO
        lo = 0
        now = time.perf_counter()
        for req in pending.requests:
            n = req.chunk.num_samples
            req.future.set_result(scores[lo:lo + n])
            lo += n
            e2e = now - req.arrival_t
            self.stats.e2e_walls_s.append(e2e)
            self.stats.samples += n
            obs.counter("serve.requests")
            obs.counter(f"serve.requests.tenant.{req.tenant}")
            obs.counter("serve.rows", n)
            obs.histogram("serve.e2e_seconds", e2e)
            dominant = slo.observe_batch(e2e, stages)
            if req.trace is not None:
                # the flow finishes inside the read-back slice
                req.trace.flow("f", t_r0)
                req.trace.finish("ok" if dominant is None else "deadline", e2e_s=e2e)
            if dominant is not None:
                self.stats.deadline_violations += 1
                self.stats.violations_by_stage[dominant] = (
                    self.stats.violations_by_stage.get(dominant, 0) + 1
                )
        # the read-back event has fired: no kernel reads these tables now
        self.registry.release(pending.tenant, pending.scorer)
        obs.flight.record("serve_batch", batch=self.stats.batches, tenant=pending.tenant,
                          requests=len(pending.requests), rows=pending.rows,
                          wall_s=round(wall, 6))

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        """Host-only engine state for summaries (the JAX engine's keys)."""
        self.stats.shed = self.queue.shed_count
        counters = obs.get_registry().snapshot()["counters"]
        return {
            "batches": self.stats.batches,
            "requests": len(self.stats.e2e_walls_s),
            "rows": self.stats.samples,
            "shed": self.stats.shed,
            "batch_retries": self.stats.batch_retries,
            "dispatch_failures": int(counters.get("serve.dispatch_failures", 0)),
            "deadline_violations": self.stats.deadline_violations,
            "queue_depth": self.queue.depth(),
            "last_swap": self.last_swap,
            "registry": self.registry.snapshot(),
            "compiles": self.stats.compiles,
            # the zero-traffic-compile gate: every one-time cost inside the
            # serving window must be a swap-candidate build
            "swap_build_compiles": self.registry.swap_build_compiles,
        }
