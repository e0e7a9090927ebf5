"""Pure-Python Avro binary codec + object-container-file reader/writer.

The runtime image carries no Avro library, so this implements the Avro 1.x
specification directly: zigzag-varint longs, length-prefixed strings/bytes,
IEEE little-endian floats, records/enums/arrays/maps/unions/fixed, and the
object container file format (magic ``Obj\\x01``, metadata map with
``avro.schema``/``avro.codec``, sync-marker-delimited blocks, null/deflate
codecs). Wire-compatible with JVM Avro so datasets and models written here
interop with the reference's tooling (photon-client data/avro/AvroUtils).

Records are plain ``dict``s; schemas are the parsed-JSON structures from
``photon_tpu_torch.io.schemas``. Copy of photon_tpu/io/avro.py (without
its byte counter); files written by either package read in the other.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Iterable, Iterator

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string",
}


# ---------------------------------------------------------------------------
# schema helpers
# ---------------------------------------------------------------------------


def _full_name(schema: dict) -> str:
    name = schema["name"]
    ns = schema.get("namespace")
    if ns and "." not in name:
        return f"{ns}.{name}"
    return name


def _collect_named(schema: Any, registry: dict[str, dict]) -> None:
    """Register named types (record/enum/fixed) so later references by name
    resolve (e.g. ``"items": "NameTermValueAvro"``)."""
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            registry[_full_name(schema)] = schema
            registry[schema["name"]] = schema
        if t == "record":
            for f in schema["fields"]:
                _collect_named(f["type"], registry)
        elif t == "array":
            _collect_named(schema["items"], registry)
        elif t == "map":
            _collect_named(schema["values"], registry)
    elif isinstance(schema, list):
        for s in schema:
            _collect_named(s, registry)


def _resolve(schema: Any, registry: dict[str, dict]) -> Any:
    if isinstance(schema, str) and schema not in _PRIMITIVES:
        return registry[schema]
    return schema


# ---------------------------------------------------------------------------
# binary encoding
# ---------------------------------------------------------------------------


def _write_long(buf: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _write_bytes(buf: io.BytesIO, b: bytes) -> None:
    _write_long(buf, len(b))
    buf.write(b)


def _union_branch(schema: list, value: Any, registry) -> int:
    """Pick the union branch for a Python value (None → null, else the
    first compatible branch)."""
    for i, branch in enumerate(schema):
        b = _resolve(branch, registry)
        t = b if isinstance(b, str) else b.get("type")
        if value is None and t == "null":
            return i
        if value is None:
            continue
        if t == "null":
            continue
        if t == "boolean" and isinstance(value, bool):
            return i
        if t in ("int", "long") and isinstance(value, int) and not isinstance(value, bool):
            return i
        if t in ("float", "double") and isinstance(value, (int, float)) and not isinstance(value, bool):
            return i
        if t == "string" and isinstance(value, str):
            return i
        if t == "bytes" and isinstance(value, (bytes, bytearray)):
            return i
        if t in ("record", "map") and isinstance(value, dict):
            return i
        if t == "array" and isinstance(value, (list, tuple)):
            return i
        if t == "enum" and isinstance(value, str):
            return i
        if t == "fixed" and isinstance(value, (bytes, bytearray)):
            return i
    raise TypeError(f"no union branch in {schema} matches {value!r}")


def _encode(buf: io.BytesIO, schema: Any, value: Any, registry) -> None:
    schema = _resolve(schema, registry)
    if isinstance(schema, list):  # union
        idx = _union_branch(schema, value, registry)
        _write_long(buf, idx)
        _encode(buf, schema[idx], value, registry)
        return
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return
    if t == "boolean":
        buf.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        _write_long(buf, int(value))
    elif t == "float":
        buf.write(struct.pack("<f", float(value)))
    elif t == "double":
        buf.write(struct.pack("<d", float(value)))
    elif t == "bytes":
        _write_bytes(buf, bytes(value))
    elif t == "string":
        _write_bytes(buf, value.encode("utf-8"))
    elif t == "record":
        for f in schema["fields"]:
            if f["name"] in value:
                fv = value[f["name"]]
            elif "default" in f:
                fv = f["default"]
            else:
                raise ValueError(
                    f"record {schema['name']} missing field {f['name']}"
                )
            _encode(buf, f["type"], fv, registry)
    elif t == "enum":
        _write_long(buf, schema["symbols"].index(value))
    elif t == "array":
        if value:
            _write_long(buf, len(value))
            for item in value:
                _encode(buf, schema["items"], item, registry)
        _write_long(buf, 0)
    elif t == "map":
        if value:
            _write_long(buf, len(value))
            for k, v in value.items():
                _write_bytes(buf, k.encode("utf-8"))
                _encode(buf, schema["values"], v, registry)
        _write_long(buf, 0)
    elif t == "fixed":
        if len(value) != schema["size"]:
            raise ValueError("fixed size mismatch")
        buf.write(bytes(value))
    else:
        raise TypeError(f"unsupported schema {schema!r}")


# ---------------------------------------------------------------------------
# binary decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) < n:
            raise EOFError("truncated Avro data")
        self.pos += n
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # un-zigzag

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.data)


def _decode(r: _Reader, schema: Any, registry) -> Any:
    schema = _resolve(schema, registry)
    if isinstance(schema, list):  # union
        return _decode(r, schema[r.read_long()], registry)
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) == b"\x01"
    if t in ("int", "long"):
        return r.read_long()
    if t == "float":
        return struct.unpack("<f", r.read(4))[0]
    if t == "double":
        return struct.unpack("<d", r.read(8))[0]
    if t == "bytes":
        return r.read_bytes()
    if t == "string":
        return r.read_bytes().decode("utf-8")
    if t == "record":
        return {
            f["name"]: _decode(r, f["type"], registry)
            for f in schema["fields"]
        }
    if t == "enum":
        return schema["symbols"][r.read_long()]
    if t == "array":
        out = []
        while True:
            count = r.read_long()
            if count == 0:
                return out
            if count < 0:
                r.read_long()  # block byte size, unused
                count = -count
            for _ in range(count):
                out.append(_decode(r, schema["items"], registry))
    if t == "map":
        out = {}
        while True:
            count = r.read_long()
            if count == 0:
                return out
            if count < 0:
                r.read_long()
                count = -count
            for _ in range(count):
                k = r.read_bytes().decode("utf-8")
                out[k] = _decode(r, schema["values"], registry)
    if t == "fixed":
        return r.read(schema["size"])
    raise TypeError(f"unsupported schema {schema!r}")


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------


class AvroFileWriter:
    """Incremental Avro object-container writer: the header goes out at
    open, each ``append`` call encodes records into sync-marker-delimited
    blocks, and ``close`` flushes the final partial block. The streaming
    score pipeline appends one chunk at a time to each output shard while
    the next batch computes — wire format identical to
    :func:`write_avro_file` (which is now a thin wrapper)."""

    def __init__(
        self,
        path: str | os.PathLike,
        schema: dict,
        codec: str = "deflate",
        sync_interval: int = 4000,
    ):
        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported codec {codec!r}")
        self.path = path
        self.schema = schema
        self.codec = codec
        self.sync_interval = sync_interval
        self._registry: dict[str, dict] = {}
        _collect_named(schema, self._registry)
        self._sync = os.urandom(SYNC_SIZE)
        self._block = io.BytesIO()
        self._count = 0
        self.total = 0
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        meta = io.BytesIO()
        _encode(
            meta,
            {"type": "map", "values": "bytes"},
            {
                "avro.schema": json.dumps(schema).encode("utf-8"),
                "avro.codec": codec.encode("utf-8"),
            },
            self._registry,
        )
        self._f.write(meta.getvalue())
        self._f.write(self._sync)

    def _flush_block(self) -> None:
        if self._count == 0:
            return
        payload = self._block.getvalue()
        if self.codec == "deflate":
            payload = zlib.compress(payload)[2:-4]  # raw deflate per spec
        head = io.BytesIO()
        _write_long(head, self._count)
        _write_long(head, len(payload))
        self._f.write(head.getvalue())
        self._f.write(payload)
        self._f.write(self._sync)
        self._block = io.BytesIO()
        self._count = 0

    def append(self, records: Iterable[dict]) -> int:
        """Encode records into the open container; returns how many.

        A record that fails mid-encode is rolled back to its start
        offset, so the open block stays decodable (its declared count
        only ever covers fully-encoded records)."""
        n = 0
        for rec in records:
            pos = self._block.tell()
            try:
                _encode(self._block, self.schema, rec, self._registry)
            except BaseException:
                self._block.seek(pos)
                self._block.truncate()
                raise
            self._count += 1
            n += 1
            if self._count >= self.sync_interval:
                self._flush_block()
        self.total += n
        return n

    def close(self) -> int:
        """Flush the trailing block and close; returns the total count."""
        if self._f is not None:
            self._flush_block()
            self._f.close()
            self._f = None
        return self.total

    def __enter__(self) -> "AvroFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_avro_file(
    path: str | os.PathLike,
    schema: dict,
    records: Iterable[dict],
    codec: str = "deflate",
    sync_interval: int = 4000,
) -> int:
    """Write records to an Avro object container file; returns the count."""
    with AvroFileWriter(
        path, schema, codec=codec, sync_interval=sync_interval
    ) as w:
        w.append(records)
    return w.total


def iter_avro_file(path: str | os.PathLike) -> Iterator[dict]:
    """Stream records from an Avro object container file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    r = _Reader(data)
    r.pos = 4
    meta = _decode(r, {"type": "map", "values": "bytes"}, {})
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    registry: dict[str, dict] = {}
    _collect_named(schema, registry)
    sync = r.read(SYNC_SIZE)

    while not r.eof:
        count = r.read_long()
        size = r.read_long()
        payload = r.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        if r.read(SYNC_SIZE) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
        br = _Reader(payload)
        for _ in range(count):
            yield _decode(br, schema, registry)


def read_avro_file(path: str | os.PathLike) -> list[dict]:
    return list(iter_avro_file(path))


def read_schema(path: str | os.PathLike) -> dict:
    """Writer schema from a container file's header (no record decoding)."""
    with open(path, "rb") as f:
        data = f.read(1 << 20)  # header metadata is tiny
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    r = _Reader(data)
    r.pos = 4
    meta = _decode(r, {"type": "map", "values": "bytes"}, {})
    return json.loads(meta["avro.schema"].decode("utf-8"))


def avro_part_files(path: str | os.PathLike) -> list[str]:
    """The ``*.avro`` part files a path denotes: the file itself, or the
    sorted parts under a directory — the reference's multi-part HDFS dir
    convention (one enumeration site shared by the monolithic and the
    chunked/streaming readers)."""
    if os.path.isfile(path):
        return [str(path)]
    parts = sorted(
        os.path.join(path, p)
        for p in os.listdir(path)
        if p.endswith(".avro") and not p.startswith(".")
    )
    if not parts:
        raise FileNotFoundError(f"no .avro files under {path}")
    return parts


def read_avro_dir(path: str | os.PathLike) -> Iterator[dict]:
    """Read all ``*.avro`` part files under a directory (sorted), or a
    single file."""
    for p in avro_part_files(path):
        yield from iter_avro_file(p)
