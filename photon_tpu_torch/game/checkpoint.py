"""Mid-descent checkpoints and model snapshots.

Counterpart of photon_tpu/game/checkpoint.py. After every descent sweep
the per-coordinate optimizer states, the
sweep index, the grid index and the best-by-validation snapshot go to
disk. A killed fit resumes from the last completed sweep and gives the
same models bit for bit: descent is deterministic given the states (the
data layout, reservoir sampling and down-sampling all derive from the
estimator's seed), and the scores are recomputed from the states on
resume (game/descent.py sums the total afresh at every sweep boundary
for that reason).

Durability:

* **Retention** — every save is a new sequence-numbered snapshot
  (``descent-state-<seq>.npz`` + ``descent-manifest-<seq>.json``), and
  the last ``PHOTON_CHECKPOINT_KEEP`` are kept (default 2).
* **Integrity** — each manifest carries a sha256 of its array files,
  checked before a snapshot is trusted.
* **Fallback** — ``load()`` walks snapshots newest-first past a torn or
  corrupt one to the newest VALID one; only when none is valid does it
  raise :class:`CheckpointCorruptError` (naming the files).

Layout under ``<dir>/``:
    descent-checkpoint.json         head manifest (copy of the newest
                                    per-seq manifest; its presence is the
                                    cheap resume probe drivers use)
    descent-manifest-<seq>.json     per-snapshot manifest
    descent-state-<seq>.npz         flattened per-coordinate arrays
    descent-best-<seq>.npz          best-by-validation snapshot (optional)

A meshed fit (game/estimator.py) hands the checkpointer whole states,
which every rank gathers from the entity shards; rank 0 writes, and a
resume cuts each state back to its rank's shard
(``Coordinate.place_state``). So a snapshot on disk does not depend on
the topology; the estimator's fingerprint holds it.

States are torch tensors on the fit's device. A save copies all of them
to the host in one device-to-host copy; a load gives them back on the
device the caller names. Writes are atomic (tmp file + ``os.replace``),
so a crash mid-write leaves every earlier snapshot intact (the
``checkpoint.replace`` fault point sits in that window). The JAX
package's pre-retention single-file layout is not read: no port
checkpoint was ever written in it.

:class:`ModelCheckpointStore` keeps sequence-numbered MODEL snapshots
for a daily warm-started retrain. Their format is the JAX package's, so
a snapshot written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import tempfile

import numpy as np
import torch

from photon_tpu_torch.util import faults

logger = logging.getLogger(__name__)

MANIFEST = "descent-checkpoint.json"

_SEQ_MANIFEST_RE = re.compile(r"descent-manifest-(\d{8})\.json$")
_SEQ_NPZ_RE = re.compile(r"descent-(?:state|best)-(\d{8})\.npz$")

DEFAULT_KEEP = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is torn, truncated, or fails its checksum. The
    message names the file; ``path`` carries it."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint file {path}: {reason}")
        self.path = path
        self.reason = reason


def checkpoint_keep() -> int:
    """Snapshots kept per checkpoint directory: ``PHOTON_CHECKPOINT_KEEP``,
    else 2."""
    env = os.environ.get("PHOTON_CHECKPOINT_KEEP", "").strip()
    if not env:
        return DEFAULT_KEEP
    v = int(env)
    if v < 1:
        raise ValueError(f"checkpoint keep must be >= 1, got {v}")
    return v


def _leaf_items(states: dict):
    """(key, leaf) in the stable "cid/i" order of the npz."""
    for cid, state in states.items():
        parts = state if isinstance(state, (list, tuple)) else [state]
        for i, leaf in enumerate(parts):
            yield f"{cid}/{i}", leaf


def _flatten_states(states: dict) -> dict[str, np.ndarray]:
    """coordinate states (tensor | list | tuple of tensors, or numpy) →
    a flat {"cid/i": ndarray} mapping. The tensors of each device and
    dtype go to the host in ONE copy: flattened, concatenated on their
    device, copied, and split again on the host."""
    items = list(_leaf_items(states))
    flat: dict[str, np.ndarray] = {}
    groups: dict[tuple, list] = {}
    for key, leaf in items:
        if isinstance(leaf, torch.Tensor):
            groups.setdefault((leaf.device, leaf.dtype), []).append((key, leaf))
        else:
            flat[key] = np.asarray(leaf)
    for members in groups.values():
        host = torch.cat([t.detach().reshape(-1) for _, t in members]).cpu().numpy()
        at = 0
        for key, t in members:
            flat[key] = host[at : at + t.numel()].reshape(tuple(t.shape))
            at += t.numel()
    return {key: flat[key] for key, _ in items}


def _unflatten_states(npz, structure: dict, device=None) -> dict:
    """Inverse of ``_flatten_states`` given the manifest's structure:
    cid → {"kind": "array" | "list" | "tuple", "parts": n}. Tensors on
    ``device`` (the CPU when None)."""
    states = {}
    for cid, info in structure.items():
        parts = [
            torch.from_numpy(np.array(npz[f"{cid}/{i}"])).to(device or "cpu")
            for i in range(info["parts"])
        ]
        if info["kind"] == "array":
            states[cid] = parts[0]
        elif info["kind"] == "tuple":
            states[cid] = tuple(parts)
        else:
            states[cid] = parts
    return states


def _structure_of(states: dict) -> dict:
    out = {}
    for cid, state in states.items():
        if isinstance(state, tuple):
            out[cid] = {"kind": "tuple", "parts": len(state)}
        elif isinstance(state, list):
            out[cid] = {"kind": "list", "parts": len(state)}
        else:
            out[cid] = {"kind": "array", "parts": 1}
    return out


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_write_npz(path: str, arrays: dict) -> str:
    """Write ``arrays`` as an npz at ``path`` via tmp + rename; returns
    the sha256 of the bytes that landed (hashed from the tmp file before
    the rename)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        digest = _sha256_file(tmp)
        # fault point: the tmp file is written, the rename not yet done;
        # the previous snapshot must stay loadable
        faults.fault_point("checkpoint.replace")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return digest


def _write_text_atomic(directory: str, path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _check_file(path: str, checksum: str | None) -> None:
    if not os.path.exists(path):
        raise CheckpointCorruptError(path, "file missing")
    if checksum is not None:
        actual = _sha256_file(path)
        if actual != checksum:
            raise CheckpointCorruptError(
                path, f"sha256 mismatch (manifest {checksum[:12]}…, file {actual[:12]}…)"
            )


def _load_npz_checked(path: str, structure: dict, checksum: str | None, device=None) -> dict:
    """Load + unflatten one npz; every torn-file failure (missing,
    truncated zip, missing member, checksum mismatch) becomes a
    :class:`CheckpointCorruptError`."""
    _check_file(path, checksum)
    try:
        with np.load(path) as npz:
            return _unflatten_states(npz, structure, device)
    except Exception as e:  # zipfile.BadZipFile, KeyError, OSError, ...
        raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") from e


@dataclasses.dataclass
class DescentCheckpoint:
    """One loaded checkpoint."""

    grid_index: int
    iteration: int  # last COMPLETED sweep (0-based); -1: grid done
    states: dict
    best_states: dict | None
    best_metric: float | None


class DescentCheckpointer:
    """Sweep callback writing a checkpoint after every sweep, plus the
    loader used by ``GameEstimator.fit(checkpoint_dir=...)``."""

    def __init__(self, directory: str):
        self.directory = directory
        self.keep = checkpoint_keep()
        os.makedirs(directory, exist_ok=True)
        # continue the sequence a previous (killed) run left behind: a
        # resumed run never overwrites the snapshot it loaded from
        seqs = self._existing_seqs()
        self._next_seq = (seqs[-1] + 1) if seqs else 0

    def _state_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"descent-state-{seq:08d}.npz")

    def _best_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"descent-best-{seq:08d}.npz")

    def _manifest_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"descent-manifest-{seq:08d}.json")

    def _existing_seqs(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(_SEQ_MANIFEST_RE.match, names) if m)

    # -- saving --------------------------------------------------------

    def on_sweep(self, grid_index, iteration, states, best_states, best_metric,
                 fingerprint: str | None = None) -> None:
        self.save(grid_index, iteration, states, best_states, best_metric,
                  fingerprint=fingerprint)

    def save(self, grid_index, iteration, states, best_states, best_metric,
             *, fingerprint: str | None = None) -> None:
        faults.fault_point("checkpoint.write")
        seq = self._next_seq
        checksums = {"state": _atomic_write_npz(self._state_path(seq), _flatten_states(states))}
        if best_states is not None:
            checksums["best"] = _atomic_write_npz(
                self._best_path(seq), _flatten_states(best_states)
            )
        manifest = {
            "seq": seq,
            "grid_index": int(grid_index),
            "iteration": int(iteration),
            "best_metric": best_metric,
            "has_best": best_states is not None,
            "structure": _structure_of(states),
            "fingerprint": fingerprint,
            "checksums": checksums,
        }
        payload = json.dumps(manifest)
        _write_text_atomic(self.directory, self._manifest_path(seq), payload)
        # the head manifest is a copy of the newest per-seq manifest: a
        # crash between the two writes leaves the per-seq one to be found
        _write_text_atomic(self.directory, os.path.join(self.directory, MANIFEST), payload)
        self._next_seq = seq + 1
        self._prune(seq)

    def _prune(self, newest_seq: int) -> None:
        """Drop snapshots older than the retention window, and what a
        killed writer leaves behind: ``*.tmp`` files and manifest-less
        npz files below the cutoff. One writer per directory, so a
        ``.tmp`` seen here is not a live save's. Best-effort: a missing
        file must not fail the save that just succeeded."""
        cutoff = newest_seq - self.keep + 1
        doomed: list[str] = []
        for seq in self._existing_seqs():
            if seq < cutoff:
                doomed += [self._manifest_path(seq), self._state_path(seq), self._best_path(seq)]
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            names = []
        for name in names:
            m = _SEQ_NPZ_RE.match(name)
            if name.endswith(".tmp") or (m and int(m.group(1)) < cutoff):
                doomed.append(os.path.join(self.directory, name))
        for path in doomed:
            try:
                os.unlink(path)
            except OSError:
                pass

    def mark_grid_done(self, grid_index: int, states: dict, fingerprint: str | None = None) -> None:
        """A finished grid point checkpoints its FINAL states with the next
        grid index and iteration -1, so a resume warm-starts grid
        ``grid_index + 1`` from them without re-running ``grid_index``."""
        self.save(grid_index + 1, -1, states, None, None, fingerprint=fingerprint)

    # -- loading -------------------------------------------------------

    def _load_manifest(self, mpath: str) -> dict:
        try:
            with open(mpath) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(mpath, f"{type(e).__name__}: {e}") from e

    def _load_snapshot(self, manifest: dict, device=None) -> DescentCheckpoint:
        checksums = manifest.get("checksums") or {}
        seq = int(manifest["seq"])
        states = _load_npz_checked(
            self._state_path(seq), manifest["structure"], checksums.get("state"), device
        )
        best_states = None
        if manifest.get("has_best"):
            best_states = _load_npz_checked(
                self._best_path(seq), manifest["structure"], checksums.get("best"), device
            )
        return DescentCheckpoint(
            grid_index=manifest["grid_index"],
            iteration=manifest["iteration"],
            states=states,
            best_states=best_states,
            best_metric=manifest.get("best_metric"),
        )

    def load(self, expect_fingerprint: str | None = None, *, device=None) -> DescentCheckpoint | None:
        """The newest VALID checkpoint, its states on ``device``.

        Snapshots are tried newest-first; a torn or corrupt one (bad
        JSON, truncated npz, checksum mismatch) is logged and skipped.
        None when the directory holds no checkpoint; raises
        :class:`CheckpointCorruptError` when checkpoints exist but NONE
        validates — starting afresh over salvageable state is the
        operator's decision, not a default.

        A stored fingerprint that differs from ``expect_fingerprint`` is
        a hard ``ValueError``: state trained under other settings would
        give wrong models, and every retained snapshot shares it."""
        candidates = [self._manifest_path(s) for s in reversed(self._existing_seqs())]
        if not candidates:
            return None
        failures: list[CheckpointCorruptError] = []
        for i, mpath in enumerate(candidates):
            try:
                manifest = self._load_manifest(mpath)
                stored = manifest.get("fingerprint")
                if expect_fingerprint is not None and stored is not None and (
                    stored != expect_fingerprint
                ):
                    raise ValueError(
                        "checkpoint was written under a different training "
                        f"configuration; delete the checkpoint directory ({self.directory}) "
                        "to start fresh"
                    )
                ckpt = self._load_snapshot(manifest, device)
            except CheckpointCorruptError as e:
                failures.append(e)
                logger.warning("checkpoint snapshot invalid, falling back to the previous one: %s", e)
                continue
            if i > 0:
                logger.warning("resumed from fallback snapshot %s (newer ones were corrupt)", mpath)
            return ckpt
        raise CheckpointCorruptError(
            failures[0].path,
            f"no valid snapshot in {self.directory} ({len(failures)} tried: "
            + "; ".join(f.reason for f in failures) + ")",
        )


# ---------------------------------------------------------------------------
# Model snapshots (the daily warm-start retrain)
# ---------------------------------------------------------------------------

MODEL_MANIFEST = "model-checkpoint.json"
_MODEL_MANIFEST_RE = re.compile(r"model-manifest-(\d{8})\.json$")
_MODEL_NPZ_RE = re.compile(r"model-(\d{8})\.npz$")


class ModelCheckpointStore:
    """Sequence-numbered MODEL snapshots, the warm-start side of the
    checkpoints:

    * a DescentCheckpoint is layout-bound (the live optimizer states,
      resumable only under the same fingerprint) and lets a KILLED fit
      go on;
    * a model snapshot is layout-INDEPENDENT (exported coefficients keyed
      by entity) and lets TOMORROW's fit, over other data and other
      bucket shapes, warm-start from it through
      ``GameEstimator.fit(warm_start=<dir>)``.

    Every ``save`` writes ``model-<seq>.npz`` + ``model-manifest-<seq>.json``
    with a rising seq (continued across processes); ``load_latest``
    returns the newest snapshot that passes its sha256, falling back past
    torn ones; the last ``checkpoint_keep()`` are kept. Fixed- and
    random-effect models round-trip exactly; a matrix-factorization
    coordinate is refused with an error, not dropped."""

    def __init__(self, directory: str):
        self.directory = directory
        self.keep = checkpoint_keep()
        os.makedirs(directory, exist_ok=True)
        seqs = self._existing_seqs()
        self._next_seq = (seqs[-1] + 1) if seqs else 0

    def _npz_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"model-{seq:08d}.npz")

    def _manifest_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"model-manifest-{seq:08d}.json")

    def _existing_seqs(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(_MODEL_MANIFEST_RE.match, names) if m)

    def save(self, model) -> int:
        """Write one snapshot; returns its sequence number."""
        from photon_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel

        assert isinstance(model, GameModel)
        arrays: dict[str, np.ndarray] = {}
        coords: dict[str, dict] = {}
        for cid, cm in model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                arrays[f"{cid}/means"] = np.asarray(cm.coefficients.means)
                has_var = cm.coefficients.variances is not None
                if has_var:
                    arrays[f"{cid}/variances"] = np.asarray(cm.coefficients.variances)
                coords[cid] = {
                    "kind": "fixed",
                    "feature_shard": cm.feature_shard,
                    "task": cm.task.name,
                    "has_variances": has_var,
                }
            elif isinstance(cm, RandomEffectModel):
                arrays[f"{cid}/vocab"] = np.asarray(cm.vocab, dtype=np.str_)
                if cm.projection_matrix is not None:
                    arrays[f"{cid}/projection"] = np.asarray(cm.projection_matrix)
                bucket_meta = []
                for j, b in enumerate(cm.buckets):
                    arrays[f"{cid}/b{j}/entity_ids"] = np.asarray(b.entity_ids)
                    arrays[f"{cid}/b{j}/col_index"] = np.asarray(b.col_index)
                    arrays[f"{cid}/b{j}/coefficients"] = np.asarray(b.coefficients)
                    if b.variances is not None:
                        arrays[f"{cid}/b{j}/variances"] = np.asarray(b.variances)
                    bucket_meta.append({"has_variances": b.variances is not None})
                coords[cid] = {
                    "kind": "random",
                    "random_effect_type": cm.random_effect_type,
                    "feature_shard": cm.feature_shard,
                    "task": cm.task.name,
                    "num_features": int(cm.num_features),
                    "has_projection": cm.projection_matrix is not None,
                    "buckets": bucket_meta,
                }
            else:
                raise ValueError(
                    f"coordinate {cid!r}: {type(cm).__name__} snapshots are not supported "
                    "by the model checkpoint store (FE and RE only)"
                )
        seq = self._next_seq
        checksum = _atomic_write_npz(self._npz_path(seq), arrays)
        manifest = {
            "seq": seq,
            "task": model.task.name,
            "coordinates": coords,
            "checksums": {"model": checksum},
        }
        payload = json.dumps(manifest)
        _write_text_atomic(self.directory, self._manifest_path(seq), payload)
        _write_text_atomic(self.directory, os.path.join(self.directory, MODEL_MANIFEST), payload)
        self._next_seq = seq + 1
        self._prune(seq)
        return seq

    def _prune(self, newest_seq: int) -> None:
        cutoff = newest_seq - self.keep + 1
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for name in names:
            m = _MODEL_MANIFEST_RE.match(name) or _MODEL_NPZ_RE.match(name)
            if m and int(m.group(1)) < cutoff:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass

    def _load_snapshot(self, manifest: dict):
        from photon_tpu_torch.game.model import (
            BucketCoefficients,
            Coefficients,
            FixedEffectModel,
            GameModel,
            RandomEffectModel,
        )
        from photon_tpu_torch.types import TaskType

        path = self._npz_path(int(manifest["seq"]))
        _check_file(path, (manifest.get("checksums") or {}).get("model"))
        coordinates = {}
        try:
            with np.load(path) as npz:
                for cid, meta in manifest["coordinates"].items():
                    if meta["kind"] == "fixed":
                        coordinates[cid] = FixedEffectModel(
                            coefficients=Coefficients(
                                means=npz[f"{cid}/means"],
                                variances=(
                                    npz[f"{cid}/variances"] if meta.get("has_variances") else None
                                ),
                            ),
                            feature_shard=meta["feature_shard"],
                            task=TaskType[meta["task"]],
                        )
                        continue
                    buckets = tuple(
                        BucketCoefficients(
                            entity_ids=npz[f"{cid}/b{j}/entity_ids"],
                            col_index=npz[f"{cid}/b{j}/col_index"],
                            coefficients=npz[f"{cid}/b{j}/coefficients"],
                            variances=(
                                npz[f"{cid}/b{j}/variances"] if bm.get("has_variances") else None
                            ),
                        )
                        for j, bm in enumerate(meta["buckets"])
                    )
                    coordinates[cid] = RandomEffectModel(
                        random_effect_type=meta["random_effect_type"],
                        feature_shard=meta["feature_shard"],
                        task=TaskType[meta["task"]],
                        vocab=npz[f"{cid}/vocab"],
                        buckets=buckets,
                        num_features=int(meta["num_features"]),
                        projection_matrix=(
                            npz[f"{cid}/projection"] if meta.get("has_projection") else None
                        ),
                    )
        except Exception as e:  # zipfile.BadZipFile, KeyError, OSError, ...
            raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") from e
        return GameModel(coordinates=coordinates, task=TaskType[manifest["task"]])

    def load_latest(self):
        """(GameModel, seq) from the newest valid snapshot; None when the
        directory holds none; :class:`CheckpointCorruptError` when
        snapshots exist but none validates."""
        seqs = self._existing_seqs()
        if not seqs:
            return None
        failures: list[CheckpointCorruptError] = []
        for seq in reversed(seqs):
            try:
                with open(self._manifest_path(seq)) as f:
                    manifest = json.load(f)
                model = self._load_snapshot(manifest)
            except (OSError, json.JSONDecodeError) as e:
                failures.append(
                    CheckpointCorruptError(self._manifest_path(seq), f"{type(e).__name__}: {e}")
                )
                continue
            except CheckpointCorruptError as e:
                failures.append(e)
                logger.warning("model snapshot %d invalid, falling back: %s", seq, e)
                continue
            return model, seq
        raise CheckpointCorruptError(
            failures[0].path,
            f"no valid model snapshot in {self.directory} ({len(failures)} tried: "
            + "; ".join(f.reason for f in failures) + ")",
        )
