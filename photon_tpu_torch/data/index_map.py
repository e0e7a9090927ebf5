"""Feature index maps: feature key ⇄ column index, in memory.

Host copy of the parts of photon_tpu/data/index_map.py that the box
constraints need (the port imports nothing of the JAX package). Keys
follow the reference convention ``name + INTERSECT + term``; the
intercept's key is ``feature_key(INTERCEPT_NAME)``. The partitioned
(off-heap) map and the abstract interface are not carried over.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Mapping

INTERSECT = "\x01"  # reference GLMSuite DELIMITER between name and term
INTERCEPT_NAME = "(INTERCEPT)"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{INTERSECT}{term}"


INTERCEPT_KEY = feature_key(INTERCEPT_NAME)


class DefaultIndexMap:
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
