"""Multi-process wiring: the process group and global data distribution.

Counterpart of photon_tpu/parallel/distributed.py. Every process runs the
same program (SPMD, one process per card); this module holds the pieces
that are multi-process specific:

- ``initialize(...)``: join the job (``init_process_group`` over a TCP
  rendezvous), once per process, before ``make_mesh``;
- ``fetch_global(x, mesh)``: the host copy of an entity-sharded table,
  gathered from every entity shard — a collective every rank calls, at
  the export and checkpoint boundary only;
- ``distribute_batch(batch, mesh)``: each process keeps only its rows of
  a batch built from IDENTICAL global host data on every process.

Ingest pairing: ``distribute_batch`` needs the same global data on every
process, so a meshed fit reads the whole input on every rank (the
training driver reads with ingest shard ``(0, 1)``). Disjoint
per-process ingest (``cache.ingest_shard``) pairs with per-process fits,
the streaming ones, as in JAX.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from photon_tpu_torch import obs
from photon_tpu_torch.parallel.mesh import LocalMesh, Mesh, gather_entities, shard_batch


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    backend: str = "nccl",
    timeout_s: float | None = None,
) -> None:
    """Join the job: ``coordinator_address`` is ``host:port`` of rank 0's
    rendezvous. NCCL for the cards; Gloo for CPU processes (and for a
    group whose ranks share one card, which NCCL refuses)."""
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        **kw,
    )


def fetch_global(x: torch.Tensor, mesh: Mesh | LocalMesh) -> np.ndarray:
    """Host float64 copy of a possibly entity-sharded tensor: the whole
    entity axis, gathered from every entity shard (every rank must call
    it; off the mesh a plain copy)."""
    x = gather_entities(x, mesh)
    with obs.host_sync("export.gather"):
        # phl-ok: PHL002 export-boundary gather — the documented global materialization point
        return x.detach().to("cpu", torch.float64).numpy().copy()


#: this process's rows of a batch of the GLOBAL data (the same host arrays
#: on every process), on its device: JAX's name for ``shard_batch``
distribute_batch = shard_batch
