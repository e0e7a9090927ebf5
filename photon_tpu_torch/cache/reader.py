"""Memory-mapped reader for the packed columnar feature cache.

Counterpart of photon_tpu/cache/reader.py. ``CachedDataReader`` gives the
data the avro path produces (``read_all``: one GameData; ``iter_chunks``:
fixed-row chunks), but every numeric column is an ``np.frombuffer`` view
over an ``mmap`` of the column file: a warm replay does no avro decode and
no host assembly beyond slicing, at any ``chunk_rows``.

Lifetime: the views alias the reader's mmaps, which live as long as the
reader (numpy's buffer export pins each mmap while a view exists). A
consumer that keeps chunk columns beyond the reader's life copies them.
"""
from __future__ import annotations

import mmap
import os
from typing import Iterator, Mapping, Sequence

import numpy as np

from photon_tpu_torch.cache.format import (
    MANIFEST,
    UID_COLUMNS,
    CacheCorruptError,
    CacheStaleError,
    check_columns,
    column_dtype,
    decode_strings,
    imap_columns,
    index_map_hash,
    index_map_keys,
    load_manifest,
    shard_columns,
    shard_config_fingerprint,
    source_file_fingerprint,
    tag_columns,
)
from photon_tpu_torch.data.index_map import DefaultIndexMap
from photon_tpu_torch.game.data import CSRMatrix, GameData
from photon_tpu_torch.util import faults


class CachedDataReader:
    """mmap-backed replay of one cached dataset directory."""

    def __init__(self, directory: str, *, verify_checksums: bool = False):
        self.directory = str(directory)
        # the "cache unreadable at open" leg the front door degrades on
        faults.fault_point("cache.open")
        if not os.path.exists(os.path.join(self.directory, MANIFEST)):
            raise FileNotFoundError(f"no cache manifest under {self.directory}")
        self.manifest = load_manifest(self.directory)
        problems = check_columns(self.directory, self.manifest, verify_checksums=verify_checksums)
        if problems:
            raise CacheCorruptError(
                f"cache {self.directory} failed integrity checks: " + "; ".join(problems)
            )
        self.num_samples = int(self.manifest["num_samples"])
        self._mmaps: dict[str, mmap.mmap] = {}
        self._arrays: dict[str, np.ndarray] = {}
        self._vocabs: dict[str, np.ndarray] = {}
        self._index_maps: dict[str, DefaultIndexMap] = {}

    def _col(self, name: str) -> np.ndarray:
        """The one column-open path (numeric and blob columns alike)."""
        arr = self._arrays.get(name)
        if arr is None:
            dt = column_dtype(name)
            meta = self.manifest["columns"].get(name)
            if meta is None:
                raise CacheCorruptError(f"cache {self.directory} has no column {name!r}")
            if meta["bytes"] == 0:
                arr = self._arrays[name] = np.empty(0, dtype=dt)
                return arr
            with open(os.path.join(self.directory, name), "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._mmaps[name] = mm
            arr = self._arrays[name] = np.frombuffer(mm, dtype=dt)
        return arr

    def _vocab(self, tag: str) -> np.ndarray:
        v = self._vocabs.get(tag)
        if v is None:
            names = tag_columns(tag)
            strings = decode_strings(self._col(names["vocab_offs"]), self._col(names["vocab_blob"]))
            v = np.asarray(strings, dtype=str) if strings else np.empty(0, dtype="<U1")
            self._vocabs[tag] = v
        return v

    def validate_sources(
        self,
        source_files: Sequence[str],
        shard_configs: Mapping,
        id_tags: Sequence[str] = (),
        index_maps: Mapping | None = None,
        source_fingerprint: list | None = None,
    ) -> list[str]:
        """Staleness against what the caller is about to read: the source
        files (content sha256s), shard configs, id tags and, when the
        caller brings maps, their hashes. Returns the mismatches (empty =
        fresh). The cache may hold more shards and tags than asked for."""
        fp = self.manifest.get("fingerprint", {})
        problems: list[str] = []
        expected = (
            source_fingerprint
            if source_fingerprint is not None
            else source_file_fingerprint(source_files)
        )
        if fp.get("sources") != expected:
            problems.append(
                f"source file set changed ({len(expected)} files vs "
                f"{len(fp.get('sources', []))} cached)"
            )
        cached_cfg = fp.get("shard_configs", {})
        for name, want in shard_config_fingerprint(shard_configs).items():
            if cached_cfg.get(name) != want:
                problems.append(f"feature shard config {name!r} changed")
        missing_tags = set(id_tags) - set(fp.get("id_tags", []))
        if missing_tags:
            problems.append(f"id tags {sorted(missing_tags)} not cached")
        if index_maps:
            cached_hashes = fp.get("index_maps", {})
            for shard in shard_configs:
                imap = index_maps.get(shard)
                cached_h = cached_hashes.get(shard)
                if imap is None or cached_h is None:
                    continue
                keys = index_map_keys(imap)
                if keys is not None and index_map_hash(keys) != cached_h:
                    problems.append(f"index map for shard {shard!r} changed")
        return problems

    def raise_if_stale(self, *args, **kwargs) -> None:
        problems = self.validate_sources(*args, **kwargs)
        if problems:
            raise CacheStaleError(f"cache {self.directory} is stale: " + "; ".join(problems))

    def index_maps_for(self, shards: Sequence[str]) -> dict:
        """The stored per-shard index maps (the indices the cache was
        built with)."""
        out = {}
        for shard in shards:
            m = self._index_maps.get(shard)
            if m is None:
                names = imap_columns(shard)
                if names["offs"] not in self.manifest["columns"]:
                    raise CacheStaleError(
                        f"cache {self.directory} stores no index map for shard {shard!r}; "
                        "supply one (off-heap store or model vocabulary)"
                    )
                keys = decode_strings(self._col(names["offs"]), self._col(names["blob"]))
                m = self._index_maps[shard] = DefaultIndexMap({k: i for i, k in enumerate(keys)})
            out[shard] = m
        return out

    def _uids_slice(self, lo: int, hi: int) -> list | None:
        if not self.manifest.get("has_uids"):
            return None
        offs = self._col(UID_COLUMNS["offs"])
        mask = self._col(UID_COLUMNS["mask"])
        mv = memoryview(self._col(UID_COLUMNS["blob"]))
        return [
            str(mv[offs[i] : offs[i + 1]], "utf-8") if mask[i] else None for i in range(lo, hi)
        ]

    def _chunk(self, lo: int, hi: int, shard_configs: Mapping, id_tags: Sequence[str]) -> GameData:
        shards = {}
        for shard in shard_configs:
            names = shard_columns(shard)
            meta = self.manifest["shards"].get(shard)
            if meta is None:
                raise CacheStaleError(f"cache {self.directory} has no shard {shard!r}")
            indptr = self._col(names["indptr"])
            nz_lo, nz_hi = int(indptr[lo]), int(indptr[hi])
            shards[shard] = CSRMatrix(
                indptr=np.asarray(indptr[lo : hi + 1]) - nz_lo,
                indices=self._col(names["indices"])[nz_lo:nz_hi],
                values=self._col(names["values"])[nz_lo:nz_hi],
                num_cols=int(meta["num_cols"]),
            )
        tags = {tag: self._vocab(tag)[self._col(tag_columns(tag)["codes"])[lo:hi]] for tag in id_tags}
        return GameData(
            labels=self._col("labels.f64")[lo:hi],
            offsets=self._col("offsets.f64")[lo:hi],
            weights=self._col("weights.f64")[lo:hi],
            feature_shards=shards,
            id_tags=tags,
            uids=self._uids_slice(lo, hi),
            provenance={"source": "cache", "dir": self.directory},
        )

    def read_all(self, shard_configs: Mapping, id_tags: Sequence[str] = ()) -> GameData:
        """The monolithic replay: one GameData over the whole columns
        (numeric columns are zero-copy mmap views)."""
        faults.fault_point("cache.read")
        return self._chunk(0, self.num_samples, shard_configs, id_tags)

    def iter_chunks(
        self,
        shard_configs: Mapping,
        id_tags: Sequence[str] = (),
        chunk_rows: int = 8192,
    ) -> Iterator[GameData]:
        """Fixed-row chunks (the last one smaller), the ``iter_chunks``
        contract of ``AvroDataReader``: the same chunk shapes for the same
        ``chunk_rows`` however the source was partitioned."""
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        n = self.num_samples
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            # per chunk: occurrence k is the k-th chunk, so a fault can
            # tear the replay mid-stream (the front door then resumes the
            # avro path chunk-aligned)
            faults.fault_point("cache.read")
            yield self._chunk(lo, hi, shard_configs, id_tags)
