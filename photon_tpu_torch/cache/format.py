"""On-disk format of the packed columnar feature cache.

Counterpart of photon_tpu/cache/format.py, the same files byte for byte:
a cache that either package writes is one the other replays. A cache
directory holds ONE materialized dataset as flat, fixed-dtype,
memory-mappable column files plus a ``manifest.json`` describing them:

``labels.f64`` / ``offsets.f64`` / ``weights.f64``
    one float64 element per sample (the dtypes ``AvroDataReader.read``
    produces, so a replay is bit-identical to the avro path);
``shard.<name>.indptr.i64`` / ``.indices.i32`` / ``.values.f64``
    the CSR block of one feature shard, already index-map-resolved;
``tag.<name>.codes.i32`` + ``tag.<name>.vocab.{offs.i64,blob.u8}``
    each entity id column as a dense code per row plus the string
    vocabulary (a chunk's id column is one fancy-index into the vocab);
``uids.{offs.i64,blob.u8,mask.u8}``
    optional per-sample uids (mask 0 encodes a missing uid);
``imap.<shard>.{offs.i64,blob.u8}``
    the feature keys of the shard's index map in index order, so a warm
    run with no off-heap store gets the exact maps the cache was built
    with.

The manifest carries the format version, per-column byte sizes and
sha256 checksums (rechecked by ``cache_tool verify`` and under
``PHOTON_FEATURE_CACHE_VERIFY=1``), the chunk boundaries the writer
streamed, the per-shard ELL width levels, and the SOURCE FINGERPRINT:
shard configs + id tags + index-map hashes + the sha256 of every source
avro part file. A cache whose fingerprint no longer matches the data it
claims to replay is STALE, and the front door degrades to the avro path
instead of serving wrong rows.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Mapping, Sequence

import numpy as np

#: bump on any change to the column layout or manifest semantics — an
#: older/newer on-disk cache is rejected as unreadable, never guessed at
CACHE_FORMAT_VERSION = 1

MANIFEST = "manifest.json"

#: dtype suffix registry: every column file name ends in one of these
DTYPES = {
    "f64": np.dtype("<f8"),
    "i64": np.dtype("<i8"),
    "i32": np.dtype("<i4"),
    "u8": np.dtype("u1"),
}


class CacheError(RuntimeError):
    """Base class for feature-cache failures."""


class CacheCorruptError(CacheError):
    """The cache directory exists but cannot be trusted: bad format
    version, a column file whose size or checksum disagrees with the
    manifest, or an unreadable manifest. The front door degrades to the
    avro path — a torn cache must never serve rows."""


class CacheStaleError(CacheError):
    """The cache is internally consistent but describes DIFFERENT source
    data (file set, shard configs, id tags, or index maps changed)."""


class FeatureCacheRequiredError(CacheError):
    """``require`` mode and no fresh cache exists."""


def _safe_name(name: str) -> str:
    """Filesystem-safe column-name component: shard/tag names are config
    strings, not paths. Distinct inputs must stay distinct, so a
    sanitized name carries a hash of the original."""
    if re.fullmatch(r"[A-Za-z0-9_\-]+", name):
        return name
    digest = hashlib.sha256(name.encode("utf-8")).hexdigest()[:8]
    return re.sub(r"[^A-Za-z0-9_\-]", "_", name) + "-" + digest


def column_dtype(filename: str) -> np.dtype:
    suffix = filename.rsplit(".", 1)[-1]
    if suffix not in DTYPES:
        raise CacheCorruptError(f"unknown column dtype suffix in {filename!r}")
    return DTYPES[suffix]


def shard_columns(shard: str) -> dict[str, str]:
    s = _safe_name(shard)
    return {
        "indptr": f"shard.{s}.indptr.i64",
        "indices": f"shard.{s}.indices.i32",
        "values": f"shard.{s}.values.f64",
    }


def tag_columns(tag: str) -> dict[str, str]:
    t = _safe_name(tag)
    return {
        "codes": f"tag.{t}.codes.i32",
        "vocab_offs": f"tag.{t}.vocab.offs.i64",
        "vocab_blob": f"tag.{t}.vocab.blob.u8",
    }


def imap_columns(shard: str) -> dict[str, str]:
    s = _safe_name(shard)
    return {"offs": f"imap.{s}.offs.i64", "blob": f"imap.{s}.blob.u8"}


UID_COLUMNS = {
    "offs": "uids.offs.i64",
    "blob": "uids.blob.u8",
    "mask": "uids.mask.u8",
}


def encode_strings(values: Sequence[str]) -> tuple[bytes, bytes]:
    """(offsets int64 [n+1], utf-8 blob) for a string column."""
    blobs = [v.encode("utf-8") for v in values]
    offs = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offs[1:])
    return offs.tobytes(), b"".join(blobs)


def decode_strings(offs: np.ndarray, blob) -> list[str]:
    """``blob`` is any C-contiguous bytes-like (bytes, mmap, or a u8
    ndarray view over one)."""
    mv = memoryview(blob)
    return [
        str(mv[offs[i] : offs[i + 1]], "utf-8") for i in range(len(offs) - 1)
    ]


def sha256_bytes_of_file(path: str, chunk: int = 1 << 20) -> tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
            size += len(b)
    return h.hexdigest(), size


def canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def fingerprint_hash(fingerprint: dict) -> str:
    return hashlib.sha256(
        canonical_json(fingerprint).encode("utf-8")
    ).hexdigest()


def source_file_fingerprint(files: Sequence[str]) -> list[dict]:
    """Per-part-file identity: basename + byte size + content sha256,
    sorted content-first so the fingerprint survives a dataset being
    moved but dies with any byte of it changing."""
    out = []
    for path in files:
        digest, size = sha256_bytes_of_file(path)
        out.append(
            {"name": os.path.basename(path), "bytes": size, "sha256": digest}
        )
    return sorted(out, key=lambda e: (e["sha256"], e["name"]))


def shard_config_fingerprint(shard_configs: Mapping) -> dict:
    """The schema half of the fingerprint: which bags feed each shard and
    whether an intercept is appended — the decode-time decisions that
    change the columns a replay must reproduce."""
    out = {}
    for name, cfg in shard_configs.items():
        out[name] = {
            "feature_bags": list(cfg.feature_bags),
            "has_intercept": bool(cfg.has_intercept),
        }
    return out


def index_map_keys(index_map) -> list[str] | None:
    """Feature keys in index order, or None when the map cannot
    enumerate (an exotic store without reverse lookup) — such shards
    skip map serialization and map-hash validation."""
    keys = []
    for i in range(len(index_map)):
        k = index_map.get_feature_name(i)
        if k is None:
            return None
        keys.append(k)
    return keys


def index_map_hash(keys: Sequence[str]) -> str:
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()


def load_manifest(directory: str) -> dict:
    path = os.path.join(directory, MANIFEST)
    try:
        with open(path, encoding="utf-8") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (OSError, ValueError) as e:
        raise CacheCorruptError(f"unreadable cache manifest {path}: {e}") from e
    version = manifest.get("format_version")
    if version != CACHE_FORMAT_VERSION:
        raise CacheCorruptError(
            f"cache format version {version!r} != supported "
            f"{CACHE_FORMAT_VERSION} ({path})"
        )
    return manifest


def check_columns(
    directory: str, manifest: dict, *, verify_checksums: bool = False
) -> list[str]:
    """Structural integrity of the column files vs the manifest: exact
    byte sizes always; full sha256 recheck when ``verify_checksums``.
    Returns human-readable problems (empty = intact)."""
    problems: list[str] = []
    for name, meta in manifest.get("columns", {}).items():
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            problems.append(f"column {name} missing")
            continue
        size = os.path.getsize(path)
        if size != meta["bytes"]:
            problems.append(
                f"column {name} is {size} bytes, manifest says {meta['bytes']}"
            )
            continue
        if verify_checksums:
            digest, _ = sha256_bytes_of_file(path)
            if digest != meta["sha256"]:
                problems.append(f"column {name} sha256 mismatch (torn write?)")
    return problems
