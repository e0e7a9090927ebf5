"""The (data, entity) mesh over ``torch.distributed`` ranks.

Counterpart of photon_tpu/parallel/mesh.py. JAX runs its mesh from one
controller over N devices and lets GSPMD insert the collectives; PyTorch
has no single-process multi-device collectives, so the port is SPMD: one
process per device, every process runs the same fit, and the collectives
are written out where the JAX program's reductions are implied.

Axes, as in JAX:

- ``data``: batch rows. Fixed-effect and matrix-factorization rows are
  sharded over EVERY rank (both axes), so a fixed-effect solve uses the
  whole mesh; each rank keeps its contiguous row slice.
- ``entity``: random-effect entities. Each rank keeps its entity shard's
  lanes of every bucket; ranks on the data axis repeat the entity work,
  as JAX's replicated data axis does.

Rank r sits at (r // E, r % E) of a D×E mesh, the order JAX's row
sharding over ``("data", "entity")`` assigns row blocks in. The groups
come from a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "entity")``.

What stays replicated: coefficients of fixed effects and factor tables
(every rank holds the same tensor, made by the same operations on the
same inputs), and the ``[N]`` scores and totals of the descent (each
rank holds all N, 8 MB at 2²⁰ float64 rows). JAX's ``constrain_rows``,
which pins the [N] temporaries of a fused sweep to the row sharding
inside one compiled program, has no counterpart: the port's totals are
replicated tensors, and a fixed-effect or MF step takes its rows' slice.

Every value a solver decides on (line-search trials, stop tests) comes
out of an ``all_reduce``, which hands every rank the same bits, so every
rank takes the same branch and meets the next collective.

The collectives of a fit go through three counted wrappers
(``all_reduce_sum``, ``gather_rows``, ``gather_entities``): each call
records its kind and payload in ``Mesh.census`` (``Mesh.collectives``
counts it by kind) under the coordinate and program kind of the innermost
:func:`collective_scope` (``("fit", "other")`` outside one), with the name
of its call site where the caller gives one. The census is the port's
counterpart of JAX's communication census of compiled programs
(photon_tpu/analysis/spmd.py); ``analysis/spmd.py`` prices it and holds it
to each coordinate's ``spmd_contract()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from photon_tpu_torch import obs
from photon_tpu_torch.types import LabeledBatch, SparseBatch, resolve_device

BATCH_AXIS = "data"
ENTITY_AXIS = "entity"


class LocalMesh:
    """The mesh of a fit over no process group: one rank that holds every
    row and every entity lane, whose collectives hand back their input
    (``all_reduce_sum``, ``gather_rows``, ``gather_entities``). It is the
    default wherever a mesh is optional, so the coordinates and the
    objective take one path with or without a mesh. Its fingerprint is
    ``None``, as JAX's off the mesh."""

    distributed = False
    owns_group = False
    size = 1
    rank = 0
    entity_index = 0
    entity_shards = 1
    entity_group = None


#: the mesh of every fit that is given none
LOCAL = LocalMesh()


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the (data, entity) mesh: the ``DeviceMesh``, the
    device this rank computes on, whether ``make_mesh`` started the
    default process group (then :func:`destroy_mesh` ends it), and the
    collective calls made on it through this module by kind."""

    device_mesh: object
    device: torch.device
    owns_group: bool = False
    #: (coordinate, program kind) → {(op, site, payload bytes, group size):
    #: calls}: every counted collective with its payload (see the module
    #: docstring)
    census: dict = dataclasses.field(default_factory=dict)
    distributed = True

    @property
    def collectives(self) -> dict:
        """Calls made through this module so far, by kind."""
        out = {"all_reduce": 0, "all_gather": 0}
        for calls in self.census.values():
            for (op, _site, _nbytes, _group), n in calls.items():
                out[op.replace("-", "_")] += n
        return out

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def dims(self) -> tuple:
        return tuple(int(s) for s in self.device_mesh.mesh.shape)

    @property
    def shape(self) -> dict:
        """axis name → size, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def entity_index(self) -> int:
        return self.device_mesh.get_local_rank(ENTITY_AXIS)

    @property
    def entity_shards(self) -> int:
        return self.shape[ENTITY_AXIS]

    @property
    def entity_group(self):
        """The ranks of this rank's row of the mesh (one per entity shard)."""
        return self.device_mesh.get_group(ENTITY_AXIS)


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    num_data: int | None = None,
    num_entity: int = 1,
    *,
    device="cuda",
    backend: str | None = None,
) -> Mesh:
    """A (data, entity) mesh over the ranks of the default process group.

    Default: every rank on the data axis. ``num_data`` × ``num_entity``
    must equal the world size (``ValueError`` otherwise, JAX's message).
    An initialized default group is reused as it is. Without one,
    ``make_mesh`` starts it: from a launcher's variables (``torchrun``'s
    ``WORLD_SIZE`` > 1, ``init_method="env://"``), else as a world of one
    on an in-process store, as JAX's mesh needs no launcher for one
    device. ``backend`` defaults to NCCL on the card and Gloo on the CPU;
    nothing here swaps one backend for another after a failure. A CUDA
    ``device`` without an index becomes this process's card
    (``LOCAL_RANK``)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    owns = False
    if not dist.is_initialized():
        backend = backend or _default_backend(device)
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        owns = True
    n = dist.get_world_size()
    if num_data is None:
        num_data = n // num_entity
    if num_data * num_entity != n:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"mesh {num_data}x{num_entity} does not cover {n} devices")
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(
        device.type,
        torch.arange(n).reshape(num_data, num_entity),
        mesh_dim_names=(BATCH_AXIS, ENTITY_AXIS),
    )
    return Mesh(device_mesh=dm, device=device, owns_group=owns)


def destroy_mesh(mesh: Mesh | LocalMesh) -> None:
    """End the default process group if ``make_mesh`` started it (an
    NCCL group left open can hang the interpreter's exit)."""
    if mesh.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def parse_mesh_spec(spec: str) -> tuple[int | None, int]:
    """``--mesh`` / ``PHOTON_MESH`` spec → ``(num_data, num_entity)``.

    Accepted forms (device counts, matching ``make_mesh``):

    - ``"DxE"``  — explicit (data, entity) factorization, e.g. ``1x8``;
    - ``"N"``    — N devices, all on the data axis (``num_entity=1``);
    - ``"auto"`` — every available device, all on the data axis
      (``num_data=None`` so ``make_mesh`` divides at call time);
    - ``""`` / ``"off"`` / ``"none"`` / ``"0"`` — no mesh (callers get
      :data:`LOCAL` from :func:`resolve_mesh`).

    Raises ``ValueError`` on anything else — a typo'd mesh spec must be
    a loud config error, not a silent single-device run.
    """
    s = spec.strip().lower()
    if s in ("", "off", "none", "0"):
        raise ValueError("empty mesh spec (resolve_mesh handles disable)")
    if s == "auto":
        return None, 1
    if "x" in s:
        d_s, _, e_s = s.partition("x")
        try:
            d, e = int(d_s), int(e_s)
        except ValueError:
            raise ValueError(
                f"mesh spec must be 'DxE', 'N', or 'auto', got {spec!r}"
            ) from None
        if d < 1 or e < 1:
            raise ValueError(f"mesh factors must be >= 1, got {spec!r}")
        return d, e
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"mesh spec must be 'DxE', 'N', or 'auto', got {spec!r}"
        ) from None
    if n < 1:
        raise ValueError(f"mesh device count must be >= 1, got {spec!r}")
    return n, 1


def resolve_mesh(spec: str | None = None, *, device="cuda", backend: str | None = None
                 ) -> Mesh | LocalMesh:
    """The mesh a training run spans: ``PHOTON_MESH`` env > explicit
    ``spec`` (the ``--mesh`` flag) > no mesh. ``off``/``none``/``0``/empty
    disable: then :data:`LOCAL` (JAX returns ``None``), which callers
    thread into ``GameEstimator(mesh=...)`` as they do a mesh."""
    env = os.environ.get("PHOTON_MESH", "").strip()
    s = env or (spec or "")
    if s.strip().lower() in ("", "off", "none", "0"):
        return LOCAL
    num_data, num_entity = parse_mesh_spec(s)
    return make_mesh(num_data=num_data, num_entity=num_entity, device=device, backend=backend)


def mesh_fingerprint(mesh: Mesh | LocalMesh | None) -> tuple | None:
    """Topology of a mesh for checkpoint fingerprints: axis names and
    per-axis device counts (JAX's tuple). A checkpoint written under one
    topology must not resume under another. ``None`` off-mesh."""
    if mesh is None or not mesh.distributed:
        return None
    return (mesh.axis_names, mesh.dims)


def pad_rows_to_multiple(n: int, devices: int) -> int:
    """Round a row count up so it divides evenly across ``devices``."""
    return ((n + devices - 1) // devices) * devices


def row_range(mesh: Mesh | LocalMesh, n: int) -> tuple[int, int]:
    """This rank's rows [lo, hi) of ``n`` rows sharded over every rank
    (``n`` is padded to a multiple of the mesh size first)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks; pad them first")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def entity_range(mesh: Mesh | LocalMesh, e: int) -> tuple[int, int]:
    """This rank's lanes [lo, hi) of ``e`` entity lanes (a multiple of
    the entity shard count) over the entity axis."""
    shards = mesh.entity_shards
    if e % shards:
        raise ValueError(f"{e} entity lanes do not divide over {shards} entity shards")
    per = e // shards
    return mesh.entity_index * per, (mesh.entity_index + 1) * per


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a batch, rows sharded over every rank (the
    feature dimension whole). A sparse batch's window layout is dropped:
    windows shard on their instance axis (parallel/sparse.shard_windows),
    not on rows."""
    lo, hi = row_range(mesh, batch.labels.shape[0])

    def rows(t):
        return t[lo:hi].to(mesh.device)

    if isinstance(batch, SparseBatch):
        return SparseBatch(
            indices=rows(batch.indices), values=rows(batch.values),
            labels=rows(batch.labels), offsets=rows(batch.offsets),
            weights=rows(batch.weights), windows=None,
        )
    return LabeledBatch(
        features=rows(batch.features), labels=rows(batch.labels),
        offsets=rows(batch.offsets), weights=rows(batch.weights),
    )


def replicate(tree, mesh: Mesh):
    """A tree of tensors on this rank's device. Replication in the port is
    a property of the program (every rank computes the same tensor from
    the same inputs), so placing it is a plain copy to the device."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(t, mesh) for t in tree)
    return tree.to(mesh.device)


#: named call sites of the census: a windowed fixed effect's [N] row
#: vector gathered once per gradient, the [N] score of a fixed effect or
#: MF gathered from the ranks' row slices (both from the replicated [N]
#: totals, ROADMAP C9), and a random effect's score summed over its
#: entity shards
ROW_GATHER_SITE = "windowed_fe_rows"
SCORE_GATHER_SITE = "replicated_scores"
RE_FOLD_SITE = "re_score_fold"

#: the scope the collectives made on this thread are attributed to
_scope = threading.local()
#: the coordinate of a collective made outside every coordinate's scope
#: (checkpoint flags, export gathers)
FIT_SCOPE = "fit"


@contextlib.contextmanager
def collective_scope(coordinate: str | None = None, program: str | None = None):
    """Attribute the counted collectives made inside to ``coordinate`` and
    ``program`` (a kind: ``"train"``, ``"score"``); a None part keeps the
    enclosing scope's."""
    prev = current_scope()
    _scope.value = (prev[0] if coordinate is None else coordinate,
                    prev[1] if program is None else program)
    try:
        yield
    finally:
        _scope.value = prev


def current_scope() -> tuple[str | None, str | None]:
    """The (coordinate, program) of the innermost :func:`collective_scope`
    on this thread, None where none is open."""
    return getattr(_scope, "value", (None, None))


def _record(mesh: Mesh, op: str, nbytes: int, group_size: int, site: str | None) -> None:
    coordinate, program = current_scope()
    calls = mesh.census.setdefault((coordinate or FIT_SCOPE, program or "other"), {})
    key = (op, site, int(nbytes), int(group_size))
    calls[key] = calls.get(key, 0) + 1


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | LocalMesh, group=None,
                   site: str | None = None) -> torch.Tensor:
    """Σ over the ranks of ``group`` (the mesh's world by default), in
    place; the result is the same bits on every rank. ``site`` names the
    call site in the census."""
    if not mesh.distributed:
        return t
    _record(mesh, "all-reduce", t.numel() * t.element_size(), dist.get_world_size(group), site)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_rows(local: torch.Tensor, mesh: Mesh | LocalMesh,
                site: str | None = None) -> torch.Tensor:
    """The full row vector from every rank's row slice, on every rank. Its
    payload in the census is the gathered vector, as an all-gather's
    result type prices it."""
    if not mesh.distributed:
        return local
    _record(mesh, "all-gather", local.numel() * local.element_size() * mesh.size, mesh.size,
            site)
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def gather_entities(local: torch.Tensor, mesh: Mesh | LocalMesh,
                    site: str | None = None) -> torch.Tensor:
    """The whole entity axis from every entity shard (the export and
    checkpoint boundary), on every rank."""
    shards = mesh.entity_shards
    if shards == 1:
        return local
    _record(mesh, "all-gather", local.numel() * local.element_size() * shards, shards, site)
    parts = [torch.empty_like(local) for _ in range(shards)]
    dist.all_gather(parts, local.contiguous(), group=mesh.entity_group)
    return torch.cat(parts)


def on_rank0(mesh: Mesh | LocalMesh, fn) -> None:
    """``fn()`` on rank 0 alone (the fit's file writes), with its outcome
    shared: one ``all_reduce`` of a failure flag, which also holds the
    other ranks until rank 0 is done. When ``fn`` raised, rank 0 raises
    its exception and every other rank a ``RuntimeError`` at the same
    point, so no rank is left waiting at a collective that rank 0 no
    longer reaches."""
    err = None
    if mesh.rank == 0:
        try:
            fn()
        except BaseException as e:  # shared with the other ranks, then re-raised
            err = e
    failed = err is not None
    if mesh.distributed:
        flag = torch.tensor([float(failed)], device=mesh.device)
        with obs.host_sync("mesh.write_outcome"):
            # phl-ok: PHL002 once per file write: every rank must learn rank 0's outcome
            failed = all_reduce_sum(flag, mesh).item() > 0
    if err is not None:
        raise err
    if failed:
        raise RuntimeError("rank 0's write failed; every rank of the mesh stops with it")
