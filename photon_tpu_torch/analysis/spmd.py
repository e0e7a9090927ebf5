"""The mesh's communication census and the SPMD contracts, in torch's form.

Counterpart of photon_tpu/analysis/spmd.py. JAX parses each collective
site out of a compiled program's HLO text and prices its payload; the
port has no compiled program to read, so the census is the record the
mesh's counted wrappers keep as they run (``parallel.mesh``:
``all_reduce_sum``, ``gather_rows``, ``gather_entities``): each call's
kind, payload bytes, group size and named call site, under the
coordinate and program kind (``"train"``, ``"score"``) that made it.
A site here is one distinct (kind, name, payload, group) of a program,
the counterpart of one collective in JAX's module text; ``comm_bytes``
sums one execution per site, as JAX's does.

Contracts, as JAX declares them per coordinate (``spmd_contract()``):
a random effect's solve is collective-free, its score folds one [N] row
vector over the entity axis; a fixed effect may all-reduce one d-vector
(plus scalars) per evaluation; MF one packed factor gradient. Sites that
the port's replicated [N] totals add (ROADMAP C9) are admitted by their
call-site name alone, never by widening a kind's allowance.

The sharding contract's torch form is a placement check: on a rank of a
world larger than one, a random effect's buckets and coefficient tables
hold only the rank's ``entity_range`` of their padded lanes, and a fixed
effect's or MF's rows only its ``row_range``; a table of full size there
is a finding (the O(ranks) memory JAX's replicated-table check exists
for).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

from photon_tpu_torch.analysis.shapes import ProgramFinding

__all__ = [
    "COLLECTIVE_FREE",
    "CollectiveSite",
    "CommAllowance",
    "SpmdContract",
    "census_by_op",
    "check_comm_allowance",
    "check_contracts",
    "check_placement",
    "comm_bytes",
    "communication_census",
]


@dataclasses.dataclass(frozen=True)
class CommAllowance:
    """What a program may say over the interconnect: collective ``ops``
    (JAX's HLO spelling, ``"all-reduce"``; ``"*"`` admits any) and a bound
    on each site's payload (None: unbounded). The default admits nothing."""

    ops: tuple[str, ...] = ()
    max_bytes_per_site: int | None = 0
    reason: str = ""

    def admits_op(self, op: str) -> bool:
        return "*" in self.ops or op in self.ops


#: the random-effect solve's contract: nothing crosses ranks
COLLECTIVE_FREE = CommAllowance(
    ops=(), max_bytes_per_site=0, reason="per-shard-independent program: zero collectives")


@dataclasses.dataclass(frozen=True)
class SpmdContract:
    """One coordinate's contract: ``comm`` for every program kind unless
    ``comm_overrides`` has the kind, and ``named`` for the call sites the
    census records by name (a named site with no entry falls under its
    kind's allowance)."""

    comm: CommAllowance = COLLECTIVE_FREE
    comm_overrides: Mapping[str, CommAllowance] = dataclasses.field(default_factory=dict)
    named: Mapping[str, CommAllowance] = dataclasses.field(default_factory=dict)

    def comm_for(self, kind: str) -> CommAllowance:
        return self.comm_overrides.get(kind, self.comm)

    def allowance(self, kind: str, site: str | None) -> CommAllowance:
        if site is not None and site in self.named:
            return self.named[site]
        return self.comm_for(kind)


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One distinct collective of a program: its kind, call-site name,
    payload bytes (an all-gather's gathered result), group size and the
    number of times it ran."""

    op: str
    site: str | None
    nbytes: int
    group_size: int
    calls: int

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def communication_census(census: Mapping) -> list[dict[str, Any]]:
    """A mesh's ``census`` as rows, one per (coordinate, program kind):
    ``program`` (``"<cid>:<kind>"``), ``coordinate``, ``kind``, its
    ``collective_sites``, the ``calls`` and ``bytes`` it moved, and
    ``comm_bytes`` (one execution per site)."""
    rows = []
    for (cid, kind), calls in sorted(census.items()):
        sites = [CollectiveSite(op, site, nbytes, group, n)
                 for (op, site, nbytes, group), n in sorted(calls.items(), key=str)]
        rows.append({
            "program": f"{cid}:{kind}",
            "coordinate": cid,
            "kind": kind,
            "collective_sites": [s.to_json() for s in sites],
            "calls": sum(s.calls for s in sites),
            "bytes": sum(s.calls * s.nbytes for s in sites),
            "comm_bytes": comm_bytes(sites),
        })
    return rows


def comm_bytes(sites: Iterable[CollectiveSite]) -> int:
    """Σ payload bytes over the sites, one execution each (JAX's pricing)."""
    return sum(s.nbytes for s in sites)


def census_by_op(census: Mapping) -> dict[str, dict[str, int]]:
    """Calls and bytes moved per collective kind over a whole census."""
    out: dict[str, dict[str, int]] = {}
    for calls in census.values():
        for (op, _site, nbytes, _group), n in calls.items():
            row = out.setdefault(op, {"calls": 0, "bytes": 0})
            row["calls"] += n
            row["bytes"] += n * nbytes
    return out


def check_comm_allowance(sites: Iterable[CollectiveSite], contract: SpmdContract, kind: str,
                         program: str) -> list[ProgramFinding]:
    """Every site of a program must be of a kind its allowance admits and
    within its payload bound (JAX's check, with the named sites held to
    their own allowance)."""
    findings = []
    for s in sites:
        allowance = contract.allowance(kind, s.site)
        where = f"site {s.site!r}, " if s.site else ""
        if not allowance.admits_op(s.op):
            findings.append(ProgramFinding(
                check="comm-allowance", program=program,
                message=(f"collective {s.op} of {s.nbytes} B ({where}group of {s.group_size}, "
                         f"{s.calls} calls) is not in this program's allowance "
                         f"{allowance.ops or '()'} — "
                         f"{allowance.reason or 'no collectives declared'}")))
        elif allowance.max_bytes_per_site is not None and s.nbytes > allowance.max_bytes_per_site:
            findings.append(ProgramFinding(
                check="comm-allowance", program=program,
                message=(f"collective {s.op} moves {s.nbytes} B per call ({where}{s.calls} "
                         f"calls) — over this program's {allowance.max_bytes_per_site} B/site "
                         f"allowance ({allowance.reason})")))
    return findings


def check_contracts(coordinates: Mapping[str, Any], census: Mapping) -> list[ProgramFinding]:
    """The census of a fit held to its coordinates' ``spmd_contract()``;
    what ran outside every coordinate (checkpoint flags, export gathers)
    is reported, not held."""
    findings = []
    for row in communication_census(census):
        coord = coordinates.get(row["coordinate"])
        if coord is None:
            continue
        sites = [CollectiveSite(**s) for s in row["collective_sites"]]
        findings.extend(check_comm_allowance(sites, coord.spmd_contract(), row["kind"],
                                             row["program"]))
    return findings


def check_placement(coordinates: Mapping[str, Any], mesh,
                    num_rows: int | None = None) -> list[ProgramFinding]:
    """The sharding contract at placement on this rank: every random-effect
    bucket and the coefficient table a fit starts it from
    (``initial_state()``) hold this rank's share of its padded lanes, every
    fixed-effect and MF batch its share of the ``num_rows`` padded rows (by
    default a random effect's row count). Nothing to check off a mesh or in
    a world of one."""
    if not mesh.distributed or mesh.size == 1:
        return []
    from photon_tpu_torch.parallel.mesh import pad_rows_to_multiple

    findings = []
    shards = mesh.entity_shards
    if num_rows is None:
        num_rows = next((int(c.num_samples) for c in coordinates.values()
                         if hasattr(c, "device_buckets")), None)
    for cid, coord in coordinates.items():
        if getattr(coord, "mesh", None) is not mesh:
            continue
        if hasattr(coord, "device_buckets"):
            tables = coord.initial_state()
            for i, (hb, db) in enumerate(zip(coord.dataset.buckets, coord.device_buckets)):
                e_pad = pad_rows_to_multiple(hb.features.shape[0], shards)
                held = {"bucket features": db.features.shape[0],
                        "coefficient table": tables[i].shape[0]}
                for what, n in held.items():
                    if n != e_pad // shards:
                        findings.append(ProgramFinding(
                            check="sharding-contract", program=f"{cid}:bucket{i}",
                            message=(f"{what} holds {n} entity lanes on rank {mesh.rank}, not "
                                     f"its entity_range's {e_pad // shards} of {e_pad} "
                                     f"({shards} entity shards)"
                                     + (" — the whole table on every rank"
                                        if n == e_pad and shards > 1 else ""))))
            continue
        labels = getattr(getattr(coord, "batch", coord), "labels", None)
        if labels is None or num_rows is None:
            continue
        want = num_rows // mesh.size
        if labels.shape[0] != want:
            findings.append(ProgramFinding(
                check="sharding-contract", program=f"{cid}:rows",
                message=(f"the batch holds {labels.shape[0]} rows on rank {mesh.rank}, not its "
                         f"row_range's {want} of {num_rows} ({mesh.size} ranks)"
                         + (" — every row on every rank" if labels.shape[0] == num_rows
                            else ""))))
    return findings
