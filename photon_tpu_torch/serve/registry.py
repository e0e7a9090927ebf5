"""Multi-tenant model registry: priced residency and validated hot swap.

Counterpart of photon_tpu/serve/registry.py. Several GAME models share one
card. Each tenant's entry owns a :class:`~photon_tpu_torch.game.scoring.
GameScorer` whose coefficient tables stay on the card for the life of the
entry, so no request pays the model's host-to-device copy. A load is
priced with ``obs.memory.tree_device_bytes`` over the scorer's tables and
refused when it would exceed ``PHOTON_SERVE_MEM_BYTES``
(:class:`ServeMemoryBudgetError`, at load time, never an out-of-memory
error in the middle of traffic).

**Hot swap** is double-buffered. ``begin_swap`` builds and warms the new
scorer (the second buffer) on the caller's thread while the old one keeps
serving. The candidate's tables are copied on that thread's stream; the
build ends with a synchronize of that stream, so the candidate is
complete before :meth:`apply_pending_swap` can publish it. The engine
flips between dispatches (the ``serve.swap`` fault point sits inside the
locked flip). A batch in flight holds a LEASE on the scorer it was
dispatched on: a flipped-out scorer drains, and its tables are released
(``serve.evict`` fault point, ``serve.evicted`` counter) when its last
lease retires, which the engine does only after that batch's read-back
event has fired, so no kernel can still read them when the caching
allocator takes the memory back. A candidate that fails validation
(fingerprint mismatch, a loader that raises, a layout the scorer
rejects, a failed warm-up) raises :class:`SwapValidationError` and ROLLS
BACK: the old scorer never stopped serving, no request is dropped.
``classify_failure`` calls it ``rollback``.

**Durability**: ``save_manifest`` writes ``registry.json`` (tenant → model
dir, fingerprint, table bytes, swaps; the JAX package's format) with
tmp+rename; a relaunch after a SIGKILL reloads it and serves the same
tenants.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Mapping

import numpy as np
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.game.scoring import GameScorer
from photon_tpu_torch.types import resolve_device
from photon_tpu_torch.util import compile_watch, faults
from photon_tpu_torch.util.sanitize import sanctioned_transfers

__all__ = [
    "ModelRegistry",
    "ServeMemoryBudgetError",
    "SwapValidationError",
    "model_fingerprint",
    "serve_mem_budget_bytes",
]

MANIFEST_NAME = "registry.json"


class SwapValidationError(RuntimeError):
    """A hot-swap candidate failed validation; the swap rolled back and the
    previous model never stopped serving (``classify_failure`` →
    ``rollback``)."""


class ServeMemoryBudgetError(RuntimeError):
    """Registering this model would exceed the memory budget
    (``PHOTON_SERVE_MEM_BYTES``)."""


def serve_mem_budget_bytes(config_value: int | None = None) -> int | None:
    """Budget for resident model tables: ``PHOTON_SERVE_MEM_BYTES`` env >
    the given value > None (unlimited)."""
    env = os.environ.get("PHOTON_SERVE_MEM_BYTES", "").strip()
    if env:
        v = int(env)
    elif config_value is not None:
        v = int(config_value)
    else:
        return None
    if v < 1:
        raise ValueError(f"serve memory budget must be >= 1 byte, got {v}")
    return v


def model_fingerprint(model: GameModel) -> str:
    """Order-stable sha256 over every coefficient array of a GameModel, the
    identity a swap validates against. It hashes the bytes JAX's
    ``model_fingerprint`` hashes (fixed-effect means, each bucket's entity
    ids and coefficients, MF factor tables, in coordinate order), so a
    model directory loaded by either package fingerprints the same where
    the arrays agree in dtype: the port loads fixed-effect means as
    float64, as JAX does with ``jax_enable_x64`` (ROADMAP C)."""
    h = hashlib.sha256()
    for cid in sorted(model.coordinates):
        cm = model.coordinates[cid]
        h.update(cid.encode())
        if isinstance(cm, FixedEffectModel):
            h.update(np.ascontiguousarray(cm.coefficients.means).tobytes())
        elif isinstance(cm, RandomEffectModel):
            for b in cm.buckets:
                h.update(np.ascontiguousarray(b.entity_ids).tobytes())
                h.update(np.ascontiguousarray(b.coefficients).tobytes())
        elif isinstance(cm, MatrixFactorizationModel):
            h.update(np.ascontiguousarray(cm.row_factors).tobytes())
            h.update(np.ascontiguousarray(cm.col_factors).tobytes())
        else:
            raise ValueError(f"unknown coordinate model for {cid!r}")
    return h.hexdigest()


class _TenantEntry:
    """One tenant's serving state: the active scorer, a pending (validated,
    warmed) swap candidate, the draining scorers and the per-scorer lease
    counts. The lock guards flips and lease transitions only; dispatches
    run outside it."""

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.lock = threading.Lock()
        self.active: GameScorer | None = None
        self.fingerprint: str | None = None
        self.model_dir: str | None = None
        self.table_bytes = 0
        self.pending: GameScorer | None = None
        self.pending_fingerprint: str | None = None
        self.pending_model_dir: str | None = None
        self.pending_table_bytes = 0
        #: id(scorer) → dispatches in flight
        self.leases: dict[int, int] = {}
        #: flipped-out scorers still owed a read-back
        self.draining: dict[int, GameScorer] = {}
        self.swaps = 0


class ModelRegistry:
    """Tenant → resident scorer on ``device``, priced and swap-capable."""

    def __init__(self, *, mem_budget_bytes: int | None = None, manifest_path: str | None = None,
                 device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32):
        self.mem_budget_bytes = serve_mem_budget_bytes(mem_budget_bytes)
        self.manifest_path = manifest_path
        self.device = resolve_device(device)
        self.dtype = dtype
        self._entries: dict[str, _TenantEntry] = {}
        self._lock = threading.Lock()
        #: one-time costs (compile_watch's ``backend_compiles``) spent
        #: building swap candidates: the one legitimate source inside the
        #: traffic window, so the gate is engine == swap_build_compiles
        self.swap_build_compiles = 0

    # -- residency ----------------------------------------------------------

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def entry(self, tenant: str) -> _TenantEntry:
        with self._lock:
            e = self._entries.get(tenant)
        if e is None or e.active is None:
            raise KeyError(f"tenant {tenant!r} is not registered")
        return e

    def total_table_bytes(self) -> int:
        with self._lock:
            entries = list(self._entries.values())
        total = 0
        for e in entries:
            with e.lock:
                total += e.table_bytes + e.pending_table_bytes
        return total

    def _build_scorer(self, model: GameModel, *, batch_rows: int | None,
                      ell_widths: Mapping[str, int] | None,
                      precompile_keys: list[tuple] | None = None) -> tuple[GameScorer, int]:
        """Build and warm one scorer buffer and price its tables. The build
        may run while the engine's sanitized loop is open (a swap): its
        copies are sanctioned, and it ends with a synchronize of this
        thread's stream so that the tables are complete before publish."""
        with sanctioned_transfers("model-table placement of a scorer build"):
            scorer = GameScorer(model, device=self.device, dtype=self.dtype,
                                batch_rows=batch_rows)
            if precompile_keys:
                for key in precompile_keys:
                    scorer.precompile(ell_widths=dict(key))
            else:
                scorer.precompile(ell_widths=ell_widths)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return scorer, obs.memory.tree_device_bytes(scorer._params)

    def register(self, tenant: str, model: GameModel, *, model_dir: str | None = None,
                 batch_rows: int | None = None,
                 ell_widths: Mapping[str, int] | None = None) -> dict:
        """Load a tenant's model: build the scorer, warm its batch shape,
        price the tables against the budget, publish. Returns the priced
        entry's summary."""
        with obs.span("serve.register", tenant=tenant):
            scorer, table_bytes = self._build_scorer(model, batch_rows=batch_rows,
                                                     ell_widths=ell_widths)
            budget = self.mem_budget_bytes
            if budget is not None:
                resident = self.total_table_bytes()
                if resident + table_bytes > budget:
                    raise ServeMemoryBudgetError(
                        f"loading tenant {tenant!r} needs {table_bytes} table bytes on top "
                        f"of {resident} resident — over the {budget} byte budget "
                        "(PHOTON_SERVE_MEM_BYTES)"
                    )
            fp = model_fingerprint(model)
            with self._lock:
                e = self._entries.setdefault(tenant, _TenantEntry(tenant))
            with e.lock:
                if e.active is not None:
                    raise ValueError(
                        f"tenant {tenant!r} already registered — use begin_swap for a "
                        "live replacement"
                    )
                e.active = scorer
                e.fingerprint = fp
                e.model_dir = model_dir
                e.table_bytes = table_bytes
        obs.counter("serve.models_loaded")
        obs.instant("serve.model_loaded", cat="lifecycle", tenant=tenant,
                    table_bytes=table_bytes, fingerprint=fp[:16])
        self.save_manifest()
        return {"tenant": tenant, "fingerprint": fp, "table_bytes": table_bytes}

    # -- leases (the drain protocol) ----------------------------------------

    def acquire(self, tenant: str) -> GameScorer:
        """Take a dispatch lease on the tenant's ACTIVE scorer: a flip moves
        it to the draining set, but its tables survive until
        :meth:`release`."""
        e = self.entry(tenant)
        with e.lock:
            scorer = e.active
            e.leases[id(scorer)] = e.leases.get(id(scorer), 0) + 1
            return scorer

    def release(self, tenant: str, scorer: GameScorer) -> None:
        """Retire one dispatch lease. The last lease on a DRAINING scorer
        drops its tables (the old buffer of a completed swap)."""
        e = self.entry(tenant)
        evicted = False
        with e.lock:
            sid = id(scorer)
            n = e.leases.get(sid, 0) - 1
            if n > 0:
                e.leases[sid] = n
            else:
                e.leases.pop(sid, None)
                if sid in e.draining:
                    faults.fault_point("serve.evict")
                    e.draining.pop(sid)
                    evicted = True
        if evicted:
            obs.counter("serve.evicted")
            obs.instant("serve.old_model_evicted", cat="lifecycle", tenant=tenant)

    def in_flight(self, tenant: str) -> int:
        e = self.entry(tenant)
        with e.lock:
            return sum(e.leases.values())

    # -- hot swap -----------------------------------------------------------

    def begin_swap(self, tenant: str, loader: Callable[[], GameModel] | GameModel, *,
                   model_dir: str | None = None, expect_fingerprint: str | None = None,
                   batch_rows: int | None = None) -> dict:
        """Stage a validated, warmed swap candidate (the second buffer).
        A validation failure raises :class:`SwapValidationError` and leaves
        the active scorer untouched; the engine applies the flip between
        dispatches through :meth:`apply_pending_swap`."""
        e = self.entry(tenant)
        old = e.active
        t0 = time.perf_counter()
        try:
            with obs.span("serve.swap_build", tenant=tenant):
                model = loader() if callable(loader) else loader
                fp = model_fingerprint(model)
                if expect_fingerprint is not None and fp != expect_fingerprint:
                    raise SwapValidationError(
                        f"swap candidate for tenant {tenant!r} fingerprints {fp[:16]}…, "
                        f"expected {expect_fingerprint[:16]}… — refusing to serve a model "
                        "that is not the one promised"
                    )
                # the second buffer warms the shape keys the live scorer
                # serves, so the first post-flip batch allocates nothing
                cw0 = compile_watch.snapshot()
                scorer, table_bytes = self._build_scorer(
                    model,
                    batch_rows=(batch_rows if batch_rows is not None
                                else (old.batch_rows if old is not None else None)),
                    ell_widths=None,
                    precompile_keys=(list(old.aot_executables())
                                     if old is not None and old.aot_executables() else None),
                )
                self.swap_build_compiles += compile_watch.delta(cw0)["backend_compiles"]
        except SwapValidationError:
            obs.counter("serve.swap_rollbacks")
            raise
        except Exception as exc:
            obs.counter("serve.swap_rollbacks")
            raise SwapValidationError(
                f"swap candidate for tenant {tenant!r} failed validation "
                f"({type(exc).__name__}: {exc}); previous model keeps serving"
            ) from exc
        with e.lock:
            e.pending = scorer
            e.pending_fingerprint = fp
            e.pending_model_dir = model_dir
            e.pending_table_bytes = table_bytes
        obs.counter("serve.swaps_staged")
        return {"tenant": tenant, "fingerprint": fp, "table_bytes": table_bytes,
                "build_wall_s": round(time.perf_counter() - t0, 4)}

    def has_pending_swap(self, tenant: str) -> bool:
        e = self.entry(tenant)
        with e.lock:
            return e.pending is not None

    def apply_pending_swap(self, tenant: str) -> bool:
        """THE atomic flip, called by the engine between dispatches. Under
        the entry lock the old scorer moves to the draining set (its tables
        dropped by its last lease's release) and the candidate becomes
        active. Returns True when a flip happened."""
        e = self.entry(tenant)
        with e.lock:
            if e.pending is None:
                return False
            faults.fault_point("serve.swap")
            old_id = id(e.active)
            drains = bool(e.leases.get(old_id))
            if drains:
                e.draining[old_id] = e.active
            e.active = e.pending
            e.fingerprint = e.pending_fingerprint
            e.model_dir = e.pending_model_dir or e.model_dir
            e.table_bytes = e.pending_table_bytes
            e.pending = None
            e.pending_fingerprint = None
            e.pending_model_dir = None
            e.pending_table_bytes = 0
            e.swaps += 1
        obs.counter("serve.swaps")
        obs.instant("serve.swap_flipped", cat="lifecycle", tenant=tenant,
                    fingerprint=(e.fingerprint or "")[:16], old_draining=drains)
        if not drains:
            # no old dispatch in flight: the old buffer goes now
            faults.fault_point("serve.evict")
            obs.counter("serve.evicted")
        self.save_manifest()
        return True

    # -- durability ---------------------------------------------------------

    def save_manifest(self, path: str | None = None) -> str | None:
        """Publish ``registry.json`` (tenant → model dir, fingerprint, table
        bytes, swaps) with tmp+rename: a killed writer leaves the previous
        manifest or none."""
        path = path or self.manifest_path
        if path is None:
            return None
        with self._lock:
            entries = dict(self._entries)
        doc = {}
        for tenant, e in sorted(entries.items()):
            with e.lock:
                if e.active is None or e.model_dir is None:
                    continue
                doc[tenant] = {"model_dir": e.model_dir, "fingerprint": e.fingerprint,
                               "table_bytes": e.table_bytes, "swaps": e.swaps}
        tmp = f"{path}.tmp-{os.getpid()}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_manifest(path: str) -> dict:
        """Read a ``registry.json`` back (the relaunch path); a missing or
        torn manifest raises."""
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"registry manifest {path!r} is not an object")
        return doc

    def snapshot(self) -> dict:
        """Host-only registry state for summaries."""
        with self._lock:
            entries = dict(self._entries)
        out = {}
        for tenant, e in sorted(entries.items()):
            with e.lock:
                out[tenant] = {
                    "fingerprint": (e.fingerprint or "")[:16],
                    "table_bytes": e.table_bytes,
                    "swaps": e.swaps,
                    "in_flight": sum(e.leases.values()),
                    "draining": len(e.draining),
                    "pending_swap": e.pending is not None,
                }
        return out
