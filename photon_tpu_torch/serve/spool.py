"""Filesystem request/result spool: the crash-safe serving transport.

Counterpart of photon_tpu/serve/spool.py with the same envelopes: a
request written by either package is served by either, and a result read
by either. State that must survive a SIGKILL of the server lives in a
spool directory of one file per request, written with tmp+rename (a
killed writer leaves a whole file or none).

Protocol (at-least-once across a SIGKILL):

- a producer writes ``req-<seq>.npz`` (the GameData columns plus a JSON
  meta record: tenant, deadline budget, WALL-CLOCK arrival stamp);
- the server admits every pending request, and on completion writes
  ``res-<seq>.npz`` (scores, or a typed error envelope) BEFORE deleting
  the request file: a server killed between dispatch and answer leaves
  the request on disk, and the relaunch serves it again;
- ``swap-<tenant>.json`` is a hot-swap command (model dir and expected
  fingerprint); the server consumes it and publishes
  ``swap-<tenant>.done.json`` with the outcome (applied / rolled_back);
- a ``stop`` file asks the server to drain and exit.

Arrival stamps cross the process boundary as ``time.time()`` because
``perf_counter`` timebases are private to a process; the server rebases
them into its own ``perf_counter`` frame on admit, so time spent on disk,
across a server crash included, counts against the deadline and the SLO.
"""
from __future__ import annotations

import json
import os
import re
import time

import numpy as np

from photon_tpu_torch.game.data import CSRMatrix, GameData

__all__ = [
    "pending_requests",
    "read_request",
    "read_result",
    "read_swap_command",
    "rebase_arrival",
    "request_path",
    "request_seq",
    "request_stop",
    "result_path",
    "stop_requested",
    "write_request",
    "write_result",
    "write_swap_command",
    "write_swap_outcome",
]

_REQ_RE = re.compile(r"^req-(\d{6})\.npz$")


def request_path(spool_dir: str, seq: int) -> str:
    return os.path.join(spool_dir, f"req-{seq:06d}.npz")


def result_path(spool_dir: str, seq: int) -> str:
    return os.path.join(spool_dir, f"res-{seq:06d}.npz")


def request_seq(path: str) -> int:
    m = _REQ_RE.match(os.path.basename(path))
    if not m:
        raise ValueError(f"not a spool request file: {path!r}")
    return int(m.group(1))


def _atomic_savez(path: str, **arrays) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _atomic_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


# -- requests ---------------------------------------------------------------


def write_request(
    spool_dir: str,
    seq: int,
    chunk: GameData,
    *,
    tenant: str = "default",
    deadline_s: float = 30.0,
    arrival_wall: float | None = None,
) -> str:
    """Atomically publish one request envelope. ``arrival_wall`` is the
    scheduled arrival in ``time.time()`` terms (defaults to now) — the
    open-loop stamp the server's deadline math rebases."""
    os.makedirs(spool_dir, exist_ok=True)
    meta = {
        "seq": int(seq),
        "tenant": tenant,
        "deadline_s": float(deadline_s),
        "arrival_wall": (
            # phl-ok: PHL006 arrival stamp that must survive a server relaunch (cross-process aging)
            time.time() if arrival_wall is None else float(arrival_wall)
        ),
    }
    arrays: dict = {
        "meta": np.array(json.dumps(meta)),
        "labels": np.asarray(chunk.labels),
        "offsets": np.asarray(chunk.offsets),
        "weights": np.asarray(chunk.weights),
    }
    for name, m in chunk.feature_shards.items():
        arrays[f"shard.{name}.indptr"] = np.asarray(m.indptr)
        arrays[f"shard.{name}.indices"] = np.asarray(m.indices)
        arrays[f"shard.{name}.values"] = np.asarray(m.values)
        arrays[f"shard.{name}.num_cols"] = np.asarray(m.num_cols)
    for tag, col in chunk.id_tags.items():
        arrays[f"tag.{tag}"] = np.asarray(col, dtype=str)
    if chunk.uids is not None:
        arrays["uids"] = np.asarray(
            ["" if u is None else u for u in chunk.uids], dtype=str
        )
    path = request_path(spool_dir, seq)
    _atomic_savez(path, **arrays)
    return path


def read_request(path: str) -> tuple[GameData, dict]:
    """Decode one request envelope back into (GameData, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        shards: dict = {}
        tags: dict = {}
        for key in z.files:
            if key.startswith("shard.") and key.endswith(".indptr"):
                name = key[len("shard.") : -len(".indptr")]
                shards[name] = CSRMatrix(
                    indptr=z[f"shard.{name}.indptr"],
                    indices=z[f"shard.{name}.indices"],
                    values=z[f"shard.{name}.values"],
                    num_cols=int(z[f"shard.{name}.num_cols"]),
                )
            elif key.startswith("tag."):
                tags[key[len("tag.") :]] = z[key]
        uids = (
            [u or None for u in z["uids"].tolist()]
            if "uids" in z.files
            else None
        )
        chunk = GameData(
            labels=z["labels"],
            offsets=z["offsets"],
            weights=z["weights"],
            feature_shards=shards,
            id_tags=tags,
            uids=uids,
        )
    return chunk, meta


def pending_requests(spool_dir: str) -> list[str]:
    """All unanswered request files, oldest (lowest seq) first."""
    if not os.path.isdir(spool_dir):
        return []
    names = [n for n in os.listdir(spool_dir) if _REQ_RE.match(n)]
    return [os.path.join(spool_dir, n) for n in sorted(names)]


def rebase_arrival(arrival_wall: float) -> float:
    """Map a wall-clock arrival stamp into THIS process's
    ``perf_counter`` frame, preserving the elapsed-since-arrival the
    deadline math runs on (a request that sat on disk across a server
    crash has been waiting the whole time)."""
    # phl-ok: PHL006 rebases a cross-process wall stamp onto this process's monotonic clock
    return time.perf_counter() - (time.time() - float(arrival_wall))


# -- results ----------------------------------------------------------------


def write_result(
    spool_dir: str,
    seq: int,
    *,
    scores: np.ndarray | None = None,
    error: BaseException | None = None,
) -> str:
    """Publish one answer (scores, or a typed error envelope), THEN
    retire the request file: the ordering the at-least-once guarantee
    hangs on."""
    if (scores is None) == (error is None):
        raise ValueError("exactly one of scores/error must be given")
    arrays: dict = {"seq": np.asarray(int(seq))}
    if scores is not None:
        arrays["scores"] = np.asarray(scores, dtype=np.float64)
    else:
        arrays["error_type"] = np.array(type(error).__name__)
        arrays["error_message"] = np.array(str(error))
    path = result_path(spool_dir, seq)
    _atomic_savez(path, **arrays)
    req = request_path(spool_dir, seq)
    if os.path.exists(req):
        os.remove(req)
    return path


def read_result(path: str) -> dict:
    """Decode one answer: ``{"seq", "scores"}`` or
    ``{"seq", "error_type", "error_message"}``."""
    with np.load(path, allow_pickle=False) as z:
        out: dict = {"seq": int(z["seq"])}
        if "scores" in z.files:
            out["scores"] = z["scores"]
        else:
            out["error_type"] = str(z["error_type"])
            out["error_message"] = str(z["error_message"])
    return out


# -- control files ----------------------------------------------------------


def write_swap_command(
    spool_dir: str,
    tenant: str,
    model_dir: str,
    *,
    expect_fingerprint: str | None = None,
) -> str:
    """Ask the server to hot-swap ``tenant`` to the model at
    ``model_dir`` (optionally pinned to a fingerprint). One in-flight
    swap per tenant: the command file IS the lock."""
    os.makedirs(spool_dir, exist_ok=True)
    path = os.path.join(spool_dir, f"swap-{tenant}.json")
    _atomic_json(
        path,
        {
            "tenant": tenant,
            "model_dir": model_dir,
            "expect_fingerprint": expect_fingerprint,
            # phl-ok: PHL006 swap-command stamp read by other processes
            "issued_wall": time.time(),
        },
    )
    return path


def read_swap_command(spool_dir: str) -> list[dict]:
    """All pending swap commands (path included so the server can retire
    each after publishing its outcome)."""
    if not os.path.isdir(spool_dir):
        return []
    out = []
    for name in sorted(os.listdir(spool_dir)):
        if (
            name.startswith("swap-")
            and name.endswith(".json")
            and not name.endswith(".done.json")
        ):
            path = os.path.join(spool_dir, name)
            with open(path) as f:
                doc = json.load(f)
            doc["_path"] = path
            out.append(doc)
    return out


def write_swap_outcome(
    spool_dir: str, tenant: str, outcome: dict, command_path: str | None = None
) -> str:
    """Publish a swap's outcome (``{"status": "applied"|"rolled_back",
    ...}``) and retire the command file."""
    path = os.path.join(spool_dir, f"swap-{tenant}.done.json")
    _atomic_json(path, outcome)
    if command_path and os.path.exists(command_path):
        os.remove(command_path)
    return path


def request_stop(spool_dir: str) -> str:
    """Ask the server to drain and exit (the graceful stop; a SIGKILL is
    the other)."""
    os.makedirs(spool_dir, exist_ok=True)
    path = os.path.join(spool_dir, "stop")
    with open(path, "w") as f:
        # phl-ok: PHL006 stop-marker stamp read by other processes
        f.write(str(time.time()))
    return path


def stop_requested(spool_dir: str) -> bool:
    return os.path.exists(os.path.join(spool_dir, "stop"))
