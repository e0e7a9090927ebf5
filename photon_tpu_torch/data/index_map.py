"""Feature index maps: feature key ⇄ column index.

Host copy of photon_tpu/data/index_map.py (the port imports nothing of
the JAX package): the ``IndexMap`` interface (reference
index/IndexMap.scala), the in-memory ``DefaultIndexMap`` and the
``PartitionedIndexMap`` over N partition stores with global index =
local index + partition offset (reference PalDBIndexMap.scala:69-99; the
stores themselves are in ``data/native_index``). Keys follow the
reference convention ``name + INTERSECT + term``; the intercept's key is
``feature_key(INTERCEPT_NAME)``.
"""
from __future__ import annotations

import zlib
from typing import Iterable, Iterator, Mapping

INTERSECT = "\x01"  # reference GLMSuite DELIMITER between name and term
INTERCEPT_NAME = "(INTERCEPT)"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{INTERSECT}{term}"


INTERCEPT_KEY = feature_key(INTERCEPT_NAME)


class IndexMap:
    """name⇄index interface (reference index/IndexMap.scala)."""

    def get_index(self, key: str) -> int:
        raise NotImplementedError

    def get_feature_name(self, idx: int) -> str | None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        return self.get_index(key) >= 0

    @property
    def has_intercept(self) -> bool:
        return INTERCEPT_KEY in self


class DefaultIndexMap(IndexMap):
    """In-memory dict-backed index map (reference DefaultIndexMap)."""

    def __init__(self, key_to_index: Mapping[str, int]):
        self._to_index = dict(key_to_index)
        self._to_name: dict[int, str] = {v: k for k, v in self._to_index.items()}

    @staticmethod
    def from_keys(keys: Iterable[str], *, add_intercept: bool = True) -> "DefaultIndexMap":
        uniq = sorted(set(keys) - {INTERCEPT_KEY})
        mapping = {k: i for i, k in enumerate(uniq)}
        if add_intercept:
            mapping[INTERCEPT_KEY] = len(uniq)  # intercept last, like ingest
        return DefaultIndexMap(mapping)

    def get_index(self, key: str) -> int:
        return self._to_index.get(key, -1)

    def get_feature_name(self, idx: int) -> str | None:
        return self._to_name.get(idx)

    def __len__(self) -> int:
        return len(self._to_index)

    def __contains__(self, key: str) -> bool:
        return key in self._to_index

    def __iter__(self) -> Iterator[tuple[str, int]]:
        return iter(self._to_index.items())


class PartitionedIndexMap(IndexMap):
    """N partition maps with global idx = local idx + partition offset;
    the partition of a key is crc32(key) % N (stable across processes,
    unlike Python's salted ``hash``)."""

    def __init__(self, partitions: list[IndexMap]):
        self._partitions = partitions
        self._offsets = []
        off = 0
        for p in partitions:
            self._offsets.append(off)
            off += len(p)
        self._total = off

    @staticmethod
    def _partition_of(key: str, n: int) -> int:
        return zlib.crc32(key.encode("utf-8")) % n

    def get_index(self, key: str) -> int:
        n = len(self._partitions)
        p = self._partition_of(key, n)
        local = self._partitions[p].get_index(key)
        return -1 if local < 0 else local + self._offsets[p]

    def get_feature_name(self, idx: int) -> str | None:
        for p, off in zip(self._partitions, self._offsets):
            if off <= idx < off + len(p):
                return p.get_feature_name(idx - off)
        return None

    def __len__(self) -> int:
        return self._total
