"""Write-once writer of the packed columnar feature cache.

Counterpart of photon_tpu/cache/writer.py. The writer streams ``GameData``
chunks (from ``AvroDataReader.iter_chunks`` or one materialized read) into
flat column files under a private ``<cache>.tmp-<pid>`` directory, hashing
every column as it is written, and PUBLISHES atomically in
:meth:`FeatureCacheWriter.finalize`: manifest last, then one directory
rename. A killed writer leaves either the previous cache or no cache,
never a readable-but-wrong one. Droppings of killed writers
(``*.tmp-*`` / ``*.old-*`` siblings) are swept at construction.

Fault points: ``cache.write`` fires per appended chunk (a fault aborts
the build; the tmp directory never publishes) and ``cache.replace`` in
the publish window between moving the old cache aside and renaming the
new one in. The JAX package's ``cache.*`` counters and lifecycle events
are log lines here (ROADMAP A5).
"""
from __future__ import annotations

import glob
import hashlib
import logging
import os
import shutil
import time
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

from photon_tpu_torch.cache.format import (
    CACHE_FORMAT_VERSION,
    MANIFEST,
    UID_COLUMNS,
    CacheError,
    canonical_json,
    column_dtype,
    encode_strings,
    fingerprint_hash,
    imap_columns,
    index_map_hash,
    index_map_keys,
    shard_columns,
    shard_config_fingerprint,
    source_file_fingerprint,
    tag_columns,
)
from photon_tpu_torch.game.data import GameData, _ceil_pow2, slice_game_data
from photon_tpu_torch.util import faults

logger = logging.getLogger(__name__)


def report_build_failure(stage: str, exc: BaseException) -> None:
    """The one way a failed opportunistic build is reported, at every
    stage (append, finalize, writer construction, read-path build); the
    run itself goes on along the avro path."""
    logger.warning(
        "feature-cache build failed during %s (%s: %s); the run continues "
        "on the avro path",
        stage, type(exc).__name__, exc,
    )


def sweep_droppings(final_dir: str) -> None:
    """Remove the tmp/old sibling directories a killed writer left. One
    writer per cache directory by contract, so whatever matches the
    private suffixes is garbage."""
    for pattern in (f"{final_dir}.tmp-*", f"{final_dir}.old-*"):
        for stale in glob.glob(pattern):
            shutil.rmtree(stale, ignore_errors=True)


class _Column:
    """One append-only column file with a running sha256."""

    def __init__(self, directory: str, name: str):
        self.name = name
        self.dtype = column_dtype(name)
        self.path = os.path.join(directory, name)
        self.file = open(self.path, "wb")
        self.sha = hashlib.sha256()
        self.bytes = 0

    def write(self, data: bytes) -> None:
        self.file.write(data)
        self.sha.update(data)
        self.bytes += len(data)

    def write_array(self, arr: np.ndarray) -> None:
        self.write(np.ascontiguousarray(arr, dtype=self.dtype).tobytes())

    def close(self) -> None:
        if not self.file.closed:
            self.file.flush()
            os.fsync(self.file.fileno())
            self.file.close()


class FeatureCacheWriter:
    """Stream GameData chunks into a versioned columnar cache directory.

    Protocol: construct → :meth:`append` per chunk (or once with the whole
    dataset) → :meth:`finalize` (publishes) or :meth:`abort` (removes the
    tmp directory). A writer that fails mid-append leaves only its private
    tmp directory, which the next writer sweeps.
    """

    def __init__(
        self,
        final_dir: str,
        *,
        shard_configs: Mapping,
        id_tags: Sequence[str] = (),
        source_files: Sequence[str] = (),
        source_fingerprint: Sequence[dict] | None = None,
    ):
        self.final_dir = str(final_dir)
        self.shard_configs = dict(shard_configs)
        self.id_tags = tuple(id_tags)
        self.source_files = list(source_files)
        #: the per-file {name, bytes, sha256} list the front door already
        #: computed for its staleness verdict (None → finalize hashes)
        self.source_fingerprint = (
            list(source_fingerprint) if source_fingerprint is not None else None
        )
        sweep_droppings(self.final_dir)
        self.tmp_dir = f"{self.final_dir}.tmp-{os.getpid()}"
        os.makedirs(self.tmp_dir)
        self._cols: dict[str, _Column] = {}
        self._rows = 0
        self._boundaries: list[int] = [0]
        #: shard → {num_cols, nnz, max_row_nnz, widths (pow2 levels)}
        self._shards: dict[str, dict] = {}
        #: tag → insertion-ordered key → code
        self._vocab: dict[str, dict[str, int]] = {t: {} for t in self.id_tags}
        self._has_uids: bool | None = None
        self._appended = 0
        self._uid_base = 0
        self._done = False

    def _col(self, name: str) -> _Column:
        c = self._cols.get(name)
        if c is None:
            c = self._cols[name] = _Column(self.tmp_dir, name)
        return c

    def append(self, chunk: GameData) -> None:
        if self._done:
            raise CacheError("writer already finalized/aborted")
        # a fault here aborts the build before any manifest exists: the
        # cache can be absent, never torn but openable
        faults.fault_point("cache.write")
        missing = set(self.shard_configs) - set(chunk.feature_shards)
        if missing:
            raise CacheError(f"chunk lacks feature shards {sorted(missing)}")
        missing_tags = set(self.id_tags) - set(chunk.id_tags)
        if missing_tags:
            raise CacheError(f"chunk lacks id tags {sorted(missing_tags)}")
        has_uids = chunk.uids is not None
        if self._has_uids is None:
            self._has_uids = has_uids
        elif self._has_uids != has_uids:
            raise CacheError("chunks disagree on uid presence")

        n = chunk.num_samples
        self._col("labels.f64").write_array(chunk.labels)
        self._col("offsets.f64").write_array(chunk.offsets)
        self._col("weights.f64").write_array(chunk.weights)

        for shard in self.shard_configs:
            m = chunk.feature_shards[shard]
            meta = self._shards.setdefault(
                shard,
                {"num_cols": int(m.num_cols), "nnz": 0, "max_row_nnz": 0, "widths": set()},
            )
            if meta["num_cols"] != int(m.num_cols):
                raise CacheError(
                    f"shard {shard!r} width changed mid-stream "
                    f"({meta['num_cols']} -> {m.num_cols})"
                )
            names = shard_columns(shard)
            base = meta["nnz"]
            if self._appended == 0:
                # the leading 0 of the global indptr, written once
                self._col(names["indptr"]).write_array(np.zeros(1, dtype=np.int64))
            self._col(names["indptr"]).write_array(
                np.asarray(m.indptr[1:], dtype=np.int64) + base
            )
            self._col(names["indices"]).write_array(m.indices)
            self._col(names["values"]).write_array(m.values)
            meta["nnz"] = base + int(m.indptr[-1])
            if n:
                k = int(np.max(np.diff(m.indptr)))
                meta["max_row_nnz"] = max(meta["max_row_nnz"], k)
                meta["widths"].add(_ceil_pow2(max(k, 1)))

        for tag in self.id_tags:
            vocab = self._vocab[tag]
            keys = np.asarray(chunk.id_tags[tag])
            codes = np.fromiter(
                (vocab.setdefault(str(k), len(vocab)) for k in keys),
                dtype=np.int32,
                count=len(keys),
            )
            self._col(tag_columns(tag)["codes"]).write_array(codes)

        if self._has_uids:
            uids = ["" if u is None else str(u) for u in chunk.uids]
            offs, blob = encode_strings(uids)
            if self._appended == 0:
                self._col(UID_COLUMNS["offs"]).write(offs[:8])
            arr = np.frombuffer(offs, dtype=np.int64)[1:] + self._uid_base
            self._col(UID_COLUMNS["offs"]).write_array(arr)
            self._col(UID_COLUMNS["blob"]).write(blob)
            self._uid_base += len(blob)
            mask = np.fromiter((0 if u is None else 1 for u in chunk.uids), dtype=np.uint8, count=n)
            self._col(UID_COLUMNS["mask"]).write_array(mask)

        self._appended += 1
        self._rows += n
        self._boundaries.append(self._rows)

    def finalize(self, index_maps: Mapping | None = None) -> str:
        """Write the vocab and index-map columns and the manifest, fsync,
        and publish the directory atomically. Returns the final path."""
        if self._done:
            raise CacheError("writer already finalized/aborted")
        if self._has_uids is None:
            self._has_uids = False  # a zero-chunk build: an empty dataset
        for tag in self.id_tags:
            names = tag_columns(tag)
            offs, blob = encode_strings(list(self._vocab[tag]))
            self._col(names["vocab_offs"]).write(offs)
            self._col(names["vocab_blob"]).write(blob)
        imap_hashes: dict[str, str | None] = {}
        for shard in self.shard_configs:
            imap = (index_maps or {}).get(shard)
            keys = index_map_keys(imap) if imap is not None else None
            if keys is None:
                imap_hashes[shard] = None
                continue
            names = imap_columns(shard)
            offs, blob = encode_strings(keys)
            self._col(names["offs"]).write(offs)
            self._col(names["blob"]).write(blob)
            imap_hashes[shard] = index_map_hash(keys)
        # a zero-chunk build still gets every column, so the reader's
        # structural check stays uniform
        for name in ("labels.f64", "offsets.f64", "weights.f64"):
            self._col(name)
        for shard in self.shard_configs:
            self._shards.setdefault(
                shard, {"num_cols": 0, "nnz": 0, "max_row_nnz": 0, "widths": set()}
            )
            for cname in shard_columns(shard).values():
                self._col(cname)
            if self._appended == 0:
                self._col(shard_columns(shard)["indptr"]).write_array(np.zeros(1, dtype=np.int64))
        for tag in self.id_tags:
            self._col(tag_columns(tag)["codes"])

        columns = {}
        for name, col in sorted(self._cols.items()):
            col.close()
            columns[name] = {
                "dtype": name.rsplit(".", 1)[-1],
                "bytes": col.bytes,
                "sha256": col.sha.hexdigest(),
            }
        fingerprint = {
            "format_version": CACHE_FORMAT_VERSION,
            "sources": (
                self.source_fingerprint
                if self.source_fingerprint is not None
                else source_file_fingerprint(self.source_files)
            ),
            "shard_configs": shard_config_fingerprint(self.shard_configs),
            "id_tags": sorted(self.id_tags),
            "index_maps": imap_hashes,
            "ell_levels": {s: sorted(meta["widths"]) for s, meta in sorted(self._shards.items())},
        }
        manifest = {
            "format_version": CACHE_FORMAT_VERSION,
            # an epoch stamp for `cache_tool inspect` and `prune`
            "created_unix": time.time(),
            "num_samples": self._rows,
            "id_tags": list(self.id_tags),
            "has_uids": bool(self._has_uids),
            "shards": {
                s: {
                    "num_cols": meta["num_cols"],
                    "nnz": meta["nnz"],
                    "max_row_nnz": meta["max_row_nnz"],
                    "ell_width": _ceil_pow2(max(meta["max_row_nnz"], 1)) if self._rows else 1,
                    "ell_levels": sorted(meta["widths"]),
                }
                for s, meta in sorted(self._shards.items())
            },
            "chunk_boundaries": self._boundaries,
            "columns": columns,
            "fingerprint": fingerprint,
            "fingerprint_sha256": fingerprint_hash(fingerprint),
        }
        with open(os.path.join(self.tmp_dir, MANIFEST), "w", encoding="utf-8") as f:
            f.write(canonical_json(manifest))
            f.flush()
            os.fsync(f.fileno())
        self._publish()
        self._done = True
        logger.info(
            "feature cache built: %s (%d rows, %d bytes, %d columns)",
            self.final_dir, self._rows, sum(c["bytes"] for c in columns.values()), len(columns),
        )
        return self.final_dir

    def _publish(self) -> None:
        old = None
        if os.path.isdir(self.final_dir):
            old = f"{self.final_dir}.old-{os.getpid()}"
            os.rename(self.final_dir, old)
        # the kill window: tmp fully written and fsynced, the final name
        # the old cache's or absent; a kill here leaves old-or-none
        faults.fault_point("cache.replace")
        os.rename(self.tmp_dir, self.final_dir)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        for col in self._cols.values():
            try:
                col.close()
            except OSError:  # best-effort teardown
                pass
        shutil.rmtree(self.tmp_dir, ignore_errors=True)


def write_game_data(
    final_dir: str,
    data: GameData,
    *,
    shard_configs: Mapping,
    id_tags: Sequence[str] = (),
    source_files: Sequence[str] = (),
    source_fingerprint: Sequence[dict] | None = None,
    index_maps: Mapping | None = None,
    chunk_rows: int = 65536,
) -> str:
    """Cache an already-read GameData (the monolithic ingest path: no
    second decode), appended in bounded row chunks."""
    writer = FeatureCacheWriter(
        final_dir,
        shard_configs=shard_configs,
        id_tags=id_tags,
        source_files=source_files,
        source_fingerprint=source_fingerprint,
    )
    try:
        n = data.num_samples
        if 0 < n <= chunk_rows:
            writer.append(data)
        else:
            for lo in range(0, n, chunk_rows):
                writer.append(slice_game_data(data, lo, lo + chunk_rows))
        return writer.finalize(index_maps=index_maps)
    except BaseException:
        writer.abort()
        raise


def build_through(
    chunks: Iterable[GameData],
    writer: FeatureCacheWriter,
    *,
    index_maps_fn=None,
) -> Iterator[GameData]:
    """Tee a chunk stream into ``writer`` while yielding every chunk
    unchanged: the cold run builds its cache from the decode it does
    anyway. A writer failure disables the build and lets the stream
    finish; the tmp directory is aborted in the ``finally``, so an
    abandoned stream leaves no droppings. ``index_maps_fn`` gives the maps
    to embed at finalize time."""
    failed = False
    try:
        for chunk in chunks:
            if not failed:
                try:
                    writer.append(chunk)
                except Exception as e:
                    failed = True
                    report_build_failure("append", e)
            yield chunk
        if not failed:
            try:
                writer.finalize(index_maps=index_maps_fn() if index_maps_fn else None)
            except Exception as e:
                report_build_failure("finalize", e)
    finally:
        writer.abort()  # a no-op after a successful finalize
