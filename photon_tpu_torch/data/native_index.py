"""Native (C++/mmap) feature index stores: the PalDB equivalent, and the
loader of the repo's C++ host library.

Counterpart of photon_tpu/data/native_index.py (reference
PalDBIndexMap.scala:43-99): an off-heap, partitioned, memory-mapped
feature index. Stores are written partition by partition (partition of a
key = crc32(key) % N, global index = local index + partition offset, as
``PartitionedIndexMap`` reads them) and opened read-only through
``native/feature_index.cpp`` (ctypes), or by the pure-Python mmap reader
of the same format when the library cannot be built. Both packages write
and read the same files.

The library: ``native/*.cpp`` (index store, columnar Avro decoder, score
writer, window builder) compiled by ``g++`` at first use into
``build/photon_tpu_torch/libphoton_native-<hash>.so``; the hash covers the
sources and the flags, so an edited source rebuilds. ``native/`` is only
read. When the build or the load fails (no compiler, no zlib headers),
``load_native_lib`` returns None and ``native_unavailable_reason`` says
why; the readers and writers then take their Python paths and report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import mmap
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Mapping, Sequence

import numpy as np

from photon_tpu_torch.data.index_map import IndexMap, PartitionedIndexMap
from photon_tpu_torch.ops.cuda_build import BUILD_DIR
from photon_tpu_torch.util import compile_watch

MAGIC = b"PHIX0001"
HEADER = struct.Struct("<8sQQQ")
METADATA_FILE = "_index_metadata.json"

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
NATIVE_SOURCES = ("feature_index.cpp", "avro_decoder.cpp", "avro_writer.cpp", "window_builder.cpp")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
CXX_LIBS = ("-lz",)


# ---------------------------------------------------------------------------
# store writer (host-side, Python — build is offline and IO-bound)
# ---------------------------------------------------------------------------


def _fnv1a64(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def write_store(path: str | os.PathLike, keys: Sequence[str]) -> None:
    """Write one partition store: keys get local indices 0..n-1 in order."""
    n = len(keys)
    if len(set(keys)) != n:
        # a duplicate would leave unreachable indices and an inconsistent
        # reverse table; fail at build time, not as wrong lookups later
        raise ValueError("duplicate keys in index store partition")
    n_buckets = 1
    while n_buckets < max(2 * n, 1):
        n_buckets *= 2

    encoded = [key.encode("utf-8") for key in keys]
    blob = bytearray()
    offsets = []
    for i, kb in enumerate(encoded):
        offsets.append(len(blob))
        blob += struct.pack("<II", len(kb), i)
        blob += kb

    buckets = [0] * n_buckets
    mask = n_buckets - 1
    for i, kb in enumerate(encoded):
        b = _fnv1a64(kb) & mask
        while buckets[b] != 0:
            b = (b + 1) & mask
        buckets[b] = offsets[i] + 1

    with open(path, "wb") as f:
        f.write(HEADER.pack(MAGIC, n, n_buckets, len(blob)))
        f.write(struct.pack(f"<{n_buckets}Q", *buckets))
        if n:
            f.write(struct.pack(f"<{n}Q", *offsets))
        f.write(bytes(blob))


# ---------------------------------------------------------------------------
# native library: build and load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: why the library is unavailable (None while it is loaded or untried)
native_unavailable_reason: str | None = None


def native_library_path() -> Path:
    digest = hashlib.sha256()
    for name in NATIVE_SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    return BUILD_DIR / f"libphoton_native-{digest.hexdigest()[:16]}.so"


def _build_native_lib() -> Path:
    """Compile ``native/*.cpp`` unless an up-to-date library exists."""
    out = native_library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in NATIVE_SOURCES), *CXX_LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
        raise OSError(f"g++ failed (rc={proc.returncode}): " + " | ".join(tail))
    os.replace(tmp, out)
    compile_watch.record_native_build("photon_native", time.perf_counter() - t0)
    return out


def load_native_lib() -> ctypes.CDLL | None:
    """The C++ host library, built on first use; None (and
    ``native_unavailable_reason`` set) when it cannot be built or loaded."""
    global _lib, native_unavailable_reason
    with _lock:
        if _lib is not None or native_unavailable_reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build_native_lib()))
        except OSError as e:
            native_unavailable_reason = f"native library unavailable: {e}"
            return None
        lib.fix_open.restype = ctypes.c_void_p
        lib.fix_open.argtypes = [ctypes.c_char_p]
        lib.fix_close.restype = None
        lib.fix_close.argtypes = [ctypes.c_void_p]
        lib.fix_size.restype = ctypes.c_int64
        lib.fix_size.argtypes = [ctypes.c_void_p]
        lib.fix_get_index.restype = ctypes.c_int64
        lib.fix_get_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.fix_get_name.restype = ctypes.c_int64
        lib.fix_get_name.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# store readers
# ---------------------------------------------------------------------------


class NativeStore(IndexMap):
    """One partition, read through the C++ mmap library."""

    def __init__(self, path: str | os.PathLike):
        lib = load_native_lib()
        if lib is None:
            raise OSError(native_unavailable_reason)
        self._lib = lib
        self._handle = lib.fix_open(str(path).encode())
        if not self._handle:
            raise OSError(f"cannot open index store {path}")
        self._size = int(lib.fix_size(self._handle))

    def get_index(self, key: str) -> int:
        kb = key.encode("utf-8")
        return int(self._lib.fix_get_index(self._handle, kb, len(kb)))

    def get_feature_name(self, idx: int) -> str | None:
        # a buffer per call: the store is thread-safe, the wrapper must be too
        buf = ctypes.create_string_buffer(256)
        n = int(self._lib.fix_get_name(self._handle, idx, buf, len(buf)))
        if n < 0:
            return None
        if n > len(buf):
            buf = ctypes.create_string_buffer(n)
            self._lib.fix_get_name(self._handle, idx, buf, n)
        return buf.raw[:n].decode("utf-8")

    def __len__(self) -> int:
        return self._size

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.fix_close(self._handle)
            self._handle = None

    def __del__(self):  # release the mapping
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class PyMmapStore(IndexMap):
    """Pure-Python mmap reader of the same format (compiler-free fallback)."""

    def __init__(self, path: str | os.PathLike):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._mm) < HEADER.size:
            raise OSError(f"{path}: truncated index store")
        magic, n, n_buckets, blob_size = HEADER.unpack_from(self._mm, 0)
        if magic != MAGIC:
            raise OSError(f"{path}: bad index store magic")
        if (
            HEADER.size + 8 * (n_buckets + n) + blob_size > len(self._mm)
            or n_buckets < 1  # the writer always emits >= 1 bucket
            or n_buckets & (n_buckets - 1)
        ):
            raise OSError(f"{path}: corrupt index store header")
        self._n = n
        self._n_buckets = n_buckets
        self._buckets_off = HEADER.size
        self._reverse_off = self._buckets_off + 8 * n_buckets
        self._blob_off = self._reverse_off + 8 * n
        # validate stored offsets once at open, vectorized (as the C++
        # reader does): this fallback must still open >10⁸-key stores
        raw = np.frombuffer(self._mm, dtype="<u8", count=n_buckets, offset=self._buckets_off)
        occupied = raw[raw != 0] - 1
        rev = np.frombuffer(self._mm, dtype="<u8", count=n, offset=self._reverse_off)
        offs = np.concatenate([occupied, rev]).astype(np.int64)
        if offs.size:
            if (offs > blob_size - 8).any():  # blob_size >= 8 iff any entry
                raise OSError(f"{path}: corrupt entry offset")
            blob = np.frombuffer(self._mm, dtype=np.uint8, count=blob_size, offset=self._blob_off)
            klens = (
                blob[offs].astype(np.int64)
                | (blob[offs + 1].astype(np.int64) << 8)
                | (blob[offs + 2].astype(np.int64) << 16)
                | (blob[offs + 3].astype(np.int64) << 24)
            )
            if (klens > blob_size - 8 - offs).any():
                raise OSError(f"{path}: corrupt entry length")

    def _entry(self, off: int) -> tuple[bytes, int]:
        base = self._blob_off + off
        klen, idx = struct.unpack_from("<II", self._mm, base)
        return self._mm[base + 8 : base + 8 + klen], idx

    def get_index(self, key: str) -> int:
        kb = key.encode("utf-8")
        mask = self._n_buckets - 1
        b = _fnv1a64(kb) & mask
        for _ in range(self._n_buckets):
            (slot,) = struct.unpack_from("<Q", self._mm, self._buckets_off + 8 * b)
            if slot == 0:
                return -1
            ek, idx = self._entry(slot - 1)
            if ek == kb:
                return idx
            b = (b + 1) & mask
        return -1

    def get_feature_name(self, idx: int) -> str | None:
        if not 0 <= idx < self._n:
            return None
        (off,) = struct.unpack_from("<Q", self._mm, self._reverse_off + 8 * idx)
        key, _ = self._entry(off)
        return key.decode("utf-8")

    def __len__(self) -> int:
        return self._n

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._f.close()
            self._mm = None


def open_store(path: str | os.PathLike, prefer_native: bool = True) -> IndexMap:
    if prefer_native and load_native_lib() is not None:
        return NativeStore(path)
    return PyMmapStore(path)


# ---------------------------------------------------------------------------
# partitioned store dir (the PalDB N-store layout)
# ---------------------------------------------------------------------------


def build_partitioned_store(
    out_dir: str | os.PathLike,
    shard_keys: Mapping[str, Iterable[str]],
    num_partitions: int = 1,
) -> None:
    """Write per-shard partitioned stores (reference FeatureIndexingDriver:
    partitionBy, then one store per partition)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    meta = {"numPartitions": num_partitions, "shards": {}}
    for shard, keys in shard_keys.items():
        parts: list[list[str]] = [[] for _ in range(num_partitions)]
        for k in keys:
            # the reader's routing; must stay byte-identical
            parts[PartitionedIndexMap._partition_of(k, num_partitions)].append(k)
        sizes = []
        for p, part_keys in enumerate(parts):
            part_keys.sort()
            write_store(out / f"{shard}-{p}.phix", part_keys)
            sizes.append(len(part_keys))
        meta["shards"][shard] = sizes
    (out / METADATA_FILE).write_text(json.dumps(meta, indent=2))


def load_partitioned_store(
    store_dir: str | os.PathLike, shard: str, prefer_native: bool = True
) -> PartitionedIndexMap:
    """One shard's partition stores as a global IndexMap."""
    d = Path(store_dir)
    meta = json.loads((d / METADATA_FILE).read_text())
    if shard not in meta["shards"]:
        raise KeyError(f"shard {shard!r} not in index store {store_dir}")
    return PartitionedIndexMap(
        [
            open_store(d / f"{shard}-{p}.phix", prefer_native=prefer_native)
            for p in range(meta["numPartitions"])
        ]
    )
