"""Avro → GameData reader (reference photon-client
data/avro/AvroDataReader.scala:85-246 ``readMerged``: feature bags merged
into feature shards through an IndexMap, an intercept per shard; id tags
from record fields or metadataMap, data/GameConverters.scala:49-131).

Counterpart of photon_tpu/io/data_reader.py: the C++ columnar decoder
(io/native_avro.py) first, the record-dict decode when it declines or
fails; both give identical GameData. The reader records which decoder
produced the data and why the native one did not
(``last_decoder``/``last_decoder_reason``). A read is retried on a
transient I/O failure (``retry_call`` with ``IO_RETRY_POLICY``; reads are
idempotent), so ``iter_chunks`` retries each part file on its own; the
fault points ``io.decode`` (inside that retry) and ``io.native_decode``
(per file of the native decode, which then falls back) inject those
failures.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Mapping, Sequence

import numpy as np

from photon_tpu_torch.data import native_index
from photon_tpu_torch.data.index_map import (
    INTERCEPT_KEY,
    DefaultIndexMap,
    IndexMap,
    feature_key,
)
from photon_tpu_torch.game.data import CSRMatrix, GameData, concat_game_data, slice_game_data
from photon_tpu_torch.io.avro import avro_part_files, read_avro_dir
from photon_tpu_torch.util import faults
from photon_tpu_torch.util.retry import IO_RETRY_POLICY, is_transient_io, retry_call


@dataclasses.dataclass(frozen=True)
class FeatureShardConfig:
    """Which feature bags feed a shard (reference
    featureShardConfigurations, cli/game/GameDriver.scala)."""

    feature_bags: tuple[str, ...]
    has_intercept: bool = True


def _record_features(record: dict, bags: Sequence[str]):
    """Yield (key, value) for every feature in the record's listed bags."""
    for bag in bags:
        for f in record.get(bag) or ():
            yield feature_key(f["name"], f.get("term") or ""), float(f["value"])


def _record_label(record: dict) -> float:
    """Label, or NaN when absent: scoring data may be unlabeled; the
    validators reject non-finite labels on the training path."""
    if "label" in record and record["label"] is not None:
        return float(record["label"])
    if "response" in record and record["response"] is not None:
        return float(record["response"])
    return float("nan")


def _record_id_tag(record: dict, tag: str) -> str | None:
    v = record.get(tag)
    if v is None:
        meta = record.get("metadataMap") or {}
        v = meta.get(tag)
    return None if v is None else str(v)


class AvroDataReader:
    """Reads TrainingExampleAvro / SimplifiedResponsePrediction part files
    into a GameData plus (optionally generated) per-shard index maps."""

    def __init__(self, index_maps: Mapping[str, IndexMap] | None = None):
        self.index_maps = dict(index_maps or {})
        #: "native" or "python": the decoder of the last read
        self.last_decoder: str | None = None
        #: why the last read did not take the native decoder (None if it did)
        self.last_decoder_reason: str | None = None

    def generate_index_maps(
        self,
        records: Iterable[dict],
        shard_configs: Mapping[str, FeatureShardConfig],
    ) -> dict[str, IndexMap]:
        """Index maps from the records' keys (reference
        DefaultIndexMapLoader path)."""
        keys: dict[str, set] = {s: set() for s in shard_configs}
        for rec in records:
            for shard, cfg in shard_configs.items():
                for k, _ in _record_features(rec, cfg.feature_bags):
                    keys[shard].add(k)
        return {
            shard: DefaultIndexMap.from_keys(keys[shard], add_intercept=cfg.has_intercept)
            for shard, cfg in shard_configs.items()
        }

    def read(
        self,
        paths: str | Sequence[str],
        shard_configs: Mapping[str, FeatureShardConfig],
        *,
        id_tags: Sequence[str] = (),
    ) -> GameData:
        """Read avro files/dirs into one GameData (reference readMerged).
        ``PHOTON_NO_NATIVE_AVRO=1`` skips the native decoder. A transient
        I/O failure retries the whole read; a permanent one (a missing
        file, a bad schema) propagates at once."""
        if isinstance(paths, (str, bytes, os.PathLike)):
            paths = [paths]
        paths = [str(p) for p in paths]
        return retry_call(
            lambda: self._read(paths, shard_configs, id_tags),
            policy=IO_RETRY_POLICY, classify=is_transient_io, label="avro_read",
        )

    def _read(self, paths, shard_configs, id_tags) -> GameData:
        faults.fault_point("io.decode")
        native = None
        if os.environ.get("PHOTON_NO_NATIVE_AVRO") == "1":
            reason = "PHOTON_NO_NATIVE_AVRO=1"
        elif native_index.load_native_lib() is None:
            reason = native_index.native_unavailable_reason
        else:
            from photon_tpu_torch.io.native_avro import read_game_data_native

            try:
                native = read_game_data_native(
                    paths, shard_configs, id_tags, dict(self.index_maps)
                )
            except Exception as e:  # noqa: BLE001 - any native surprise → Python decode
                reason = f"native decode raised {type(e).__name__}: {e}"
            else:
                reason = "the schema, data or id tags are outside the native decoder's subset"
        if native is not None:
            data, maps = native
            self.index_maps.update(maps)
            self.last_decoder, self.last_decoder_reason = "native", None
            return data
        self.last_decoder, self.last_decoder_reason = "python", reason
        return self._read_records(paths, shard_configs, id_tags)

    def iter_chunks(
        self,
        paths: str | Sequence[str],
        shard_configs: Mapping[str, FeatureShardConfig],
        *,
        id_tags: Sequence[str] = (),
        chunk_rows: int = 8192,
    ):
        """``GameData`` chunks of exactly ``chunk_rows`` rows (the last one
        smaller), decoding one part file at a time; rows carry over across
        file boundaries. The index maps of every shard must be known up
        front (generating them takes a full pass over the data)."""
        if not set(shard_configs) <= set(self.index_maps):
            missing = sorted(set(shard_configs) - set(self.index_maps))
            raise ValueError(
                "chunked reads need index maps for every shard up front "
                f"(missing: {missing}); generating them requires a full "
                "pass over the data"
            )
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        if isinstance(paths, (str, bytes, os.PathLike)):
            paths = [paths]
        files = [f for p in paths for f in avro_part_files(p)]
        pending: list[GameData] = []
        buffered = 0
        for f in files:
            piece = self.read(f, shard_configs, id_tags=id_tags)
            if piece.num_samples == 0:
                continue
            pending.append(piece)
            buffered += piece.num_samples
            if buffered < chunk_rows:
                continue
            # merge once, then slice every full chunk out of the merge; a
            # merge that is exactly one chunk is handed over without a copy
            merged = concat_game_data(pending)
            lo = 0
            while merged.num_samples - lo >= chunk_rows:
                if lo == 0 and merged.num_samples == chunk_rows:
                    yield merged
                else:
                    yield slice_game_data(merged, lo, lo + chunk_rows)
                lo += chunk_rows
            if lo < merged.num_samples:
                pending = [slice_game_data(merged, lo, merged.num_samples)]
                buffered = merged.num_samples - lo
            else:
                pending = []
                buffered = 0
        if buffered:
            yield concat_game_data(pending)

    def _read_records(self, paths, shard_configs, id_tags) -> GameData:
        records = []
        for p in paths:
            records.extend(read_avro_dir(p))

        if not set(shard_configs) <= set(self.index_maps):
            generated = self.generate_index_maps(records, shard_configs)
            for shard, imap in generated.items():
                self.index_maps.setdefault(shard, imap)

        n = len(records)
        labels = np.zeros(n)
        offsets = np.zeros(n)
        weights = np.ones(n)
        uids: list[str | None] = [None] * n
        tag_values: dict[str, list] = {t: [None] * n for t in id_tags}
        shard_rows = {s: ([], [], np.zeros(n + 1, dtype=np.int64)) for s in shard_configs}

        for r, rec in enumerate(records):
            labels[r] = _record_label(rec)
            if rec.get("offset") is not None:
                offsets[r] = float(rec["offset"])
            if rec.get("weight") is not None:
                weights[r] = float(rec["weight"])
            if rec.get("uid") is not None:
                uids[r] = str(rec["uid"])
            for t in id_tags:
                v = _record_id_tag(rec, t)
                if v is None:
                    raise ValueError(
                        f"record {r} missing id tag {t!r} (top-level or metadataMap)"
                    )
                tag_values[t][r] = v
            for shard, cfg in shard_configs.items():
                imap = self.index_maps[shard]
                idx_list, val_list, indptr = shard_rows[shard]
                count = 0
                for k, v in _record_features(rec, cfg.feature_bags):
                    i = imap.get_index(k)
                    if i >= 0:
                        idx_list.append(i)
                        val_list.append(v)
                        count += 1
                if cfg.has_intercept:
                    i = imap.get_index(INTERCEPT_KEY)
                    if i >= 0:
                        idx_list.append(i)
                        val_list.append(1.0)
                        count += 1
                indptr[r + 1] = indptr[r] + count

        feature_shards = {
            shard: CSRMatrix(
                indptr=indptr,
                indices=np.asarray(idx_list, dtype=np.int32),
                values=np.asarray(val_list, dtype=np.float64),
                num_cols=len(self.index_maps[shard]),
            )
            for shard, (idx_list, val_list, indptr) in shard_rows.items()
        }
        return GameData.build(
            labels=labels,
            feature_shards=feature_shards,
            offsets=offsets,
            weights=weights,
            id_tags={t: np.asarray(vs, dtype=object) for t, vs in tag_values.items()},
            uids=uids,
        )
