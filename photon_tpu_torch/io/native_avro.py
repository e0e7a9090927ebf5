"""Native Avro ingest: schema → field program → C++ columnar decode.

The hot loop of the reference's ingest (Avro decode + feature-bag traversal
+ per-feature key handling, AvroDataReader.scala:85-246) runs in
``native/avro_decoder.cpp``; this module compiles the writer schema into
the decoder's field program, assembles the columnar output into a
``GameData`` with vectorized numpy (feature-key index lookups happen once
per UNIQUE key instead of once per occurrence), and falls back to the
pure-Python codec whenever the schema or data uses anything the fast path
doesn't cover — the two paths are record-for-record equivalent
(tests/test_native_avro.py).

Counterpart of photon_tpu/io/native_avro.py over the port's own build of
the same C++ library (``data/native_index.load_native_lib``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np

from photon_tpu_torch.data.index_map import (
    INTERCEPT_KEY,
    DefaultIndexMap,
    IndexMap,
)
from photon_tpu_torch.data.native_index import load_native_lib
from photon_tpu_torch.util import faults

_KIND = {
    "null": 0,
    "boolean": 1,
    "int": 2,
    "long": 3,
    "float": 4,
    "double": 5,
    "string": 6,
    "bytes": 7,
}
_K_FEATURES, _K_STRMAP = 8, 9
_D_IGNORE, _D_LABEL, _D_OFFSET, _D_WEIGHT, _D_UID, _D_META, _D_STRCOL, _D_BAG = (
    0, 1, 2, 3, 4, 5, 6, 7,
)
_D_LABEL_FALLBACK = 8  # 'response', used per record when 'label' is absent
_NUMERIC = {"int", "long", "float", "double", "boolean"}


def _norm(t):
    """Normalize an avro type node to (base_type_str|dict, union_info)."""
    if isinstance(t, dict) and set(t) == {"type"}:
        t = t["type"]
    if isinstance(t, list):
        if len(t) == 1:
            return _norm(t[0])
        if len(t) == 2 and "null" in t:
            other = t[0] if t[1] == "null" else t[1]
            base, inner = _norm(other)
            if inner:  # nested unions unsupported
                return None, None
            return base, (1 if t[0] == "null" else 2)
        return None, None
    return t, 0


def _feature_record_program(items) -> bytes | None:
    """Inner feature-record fields → 3-byte descriptors (or None)."""
    if not isinstance(items, dict) or items.get("type") != "record":
        return None
    out = bytearray()
    dests = {"name": 1, "term": 2, "value": 3}
    for f in items.get("fields", []):
        base, u = _norm(f["type"])
        if base is None or not isinstance(base, str) or base not in _KIND:
            return None
        dest = dests.get(f["name"], 0)
        if dest in (1, 2) and base not in ("string", "bytes"):
            return None
        if dest == 3 and base not in _NUMERIC:
            return None
        out += bytes([_KIND[base], u, dest])
    if not out:
        return None
    return bytes([len(out) // 3]) + bytes(out)


def compile_program(
    schema: dict, feature_bags: Sequence[str]
) -> tuple[bytes, list[str]] | None:
    """Writer schema → (program bytes, bag order). None ⇒ use the fallback."""
    if not isinstance(schema, dict) or schema.get("type") != "record":
        return None
    fields = schema.get("fields")
    if not isinstance(fields, list) or len(fields) > 255:
        return None

    top = bytearray()
    feat_prog: bytes | None = None
    bag_order: list[str] = []
    strcol_names: list[str] = []
    for f in fields:
        name = f["name"]
        base, u = _norm(f["type"])
        if base is None:
            return None
        if isinstance(base, dict) and base.get("type") == "array":
            inner = _feature_record_program(base.get("items"))
            if inner is None or name not in feature_bags:
                return None  # arrays of non-feature records unsupported
            if feat_prog is None:
                feat_prog = inner
            elif feat_prog != inner:
                return None  # bags must share one layout
            top += bytes([_K_FEATURES, u, _D_BAG, len(bag_order)])
            bag_order.append(name)
            continue
        if isinstance(base, dict) and base.get("type") == "map":
            vbase, vu = _norm(base.get("values"))
            if vbase not in ("string", "bytes"):
                return None
            dest = _D_META if name == "metadataMap" else _D_IGNORE
            # the bag byte carries the map-VALUE union info
            top += bytes([_K_STRMAP, u, dest, vu])
            continue
        if not isinstance(base, str) or base not in _KIND:
            return None
        if name == "label" and base in _NUMERIC:
            dest = _D_LABEL
        elif name == "response" and base in _NUMERIC:
            dest = _D_LABEL_FALLBACK
        elif name == "offset" and base in _NUMERIC:
            dest = _D_OFFSET
        elif name == "weight" and base in _NUMERIC:
            dest = _D_WEIGHT
        elif name == "uid":
            if base in ("float", "double", "boolean"):
                # str(float) formatting can't be matched bit-for-bit from
                # C; such files take the Python path
                return None
            dest = _D_UID
        elif base in ("string", "bytes"):
            dest = _D_STRCOL
            # the \x02 prefix keeps top-level string columns in a separate
            # key space from metadataMap entries, so tag resolution can give
            # them precedence (reference _record_id_tag order)
            strcol_names.append("\x02" + name)
        else:
            dest = _D_IGNORE
        top += bytes([_KIND[base], u, dest, 0])

    missing_bags = set(feature_bags) - set(bag_order)
    if missing_bags:
        return None  # requested bag not in this schema
    if feat_prog is None:
        feat_prog = bytes([0])
    names_blob = "\n".join(strcol_names).encode("utf-8")
    prog = bytes([len(top) // 4]) + bytes(top) + feat_prog + names_blob
    return prog, bag_order


# ---------------------------------------------------------------------------
# ctypes binding
# ---------------------------------------------------------------------------


class _CDecoded(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("labels", ctypes.POINTER(ctypes.c_double)),
        ("offsets", ctypes.POINTER(ctypes.c_double)),
        ("weights", ctypes.POINTER(ctypes.c_double)),
        ("n_bags", ctypes.c_int32),
        ("bag_indptr", ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))),
        ("bag_key_ids", ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))),
        ("bag_vals", ctypes.POINTER(ctypes.POINTER(ctypes.c_double))),
        ("bag_nkeys", ctypes.POINTER(ctypes.c_int64)),
        # char** on the C side, bound as void* addresses ON PURPOSE:
        # indexing a POINTER(c_char_p) materializes a TEMPORARY Python
        # bytes copy (read to the first NUL), and taking a pointer into
        # that temporary then reading it later is a use-after-free — the
        # key pool intermittently decoded as heap garbage once the
        # process had enough allocation churn (every feature key then
        # missed the index map and scoring collapsed to intercept-only).
        # An address stays valid until pml_avro_free.
        ("bag_key_pool", ctypes.POINTER(ctypes.c_void_p)),
        ("bag_key_offs", ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))),
        ("uid_pool", ctypes.POINTER(ctypes.c_char)),
        ("uid_offs", ctypes.POINTER(ctypes.c_int64)),
        ("n_meta", ctypes.c_int64),
        ("meta_row", ctypes.POINTER(ctypes.c_int64)),
        ("meta_key_id", ctypes.POINTER(ctypes.c_int32)),
        ("n_meta_keys", ctypes.c_int64),
        ("meta_key_pool", ctypes.POINTER(ctypes.c_char)),
        ("meta_key_offs", ctypes.POINTER(ctypes.c_int64)),
        ("meta_val_pool", ctypes.POINTER(ctypes.c_char)),
        ("meta_val_offs", ctypes.POINTER(ctypes.c_int64)),
        ("err", ctypes.c_char * 512),
    ]


def _lib():
    lib = load_native_lib()
    if lib is None:
        return None
    lib.pml_avro_decode.restype = ctypes.POINTER(_CDecoded)
    lib.pml_avro_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.pml_avro_free.restype = None
    lib.pml_avro_free.argtypes = [ctypes.POINTER(_CDecoded)]
    return lib


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _pool_strings(pool_ptr, offs: np.ndarray) -> list[str]:
    """Slice a concatenated C string pool into Python strings. ``pool_ptr``
    must reference the C-owned buffer directly (a POINTER(c_char) field or
    a raw address) — never a pointer into a temporary Python bytes object,
    which is freed before the read (the bag_key_pool UAF above)."""
    total = int(offs[-1]) if len(offs) else 0
    raw = ctypes.string_at(pool_ptr, total) if total else b""
    return [
        raw[offs[i] : offs[i + 1]].decode("utf-8")
        for i in range(len(offs) - 1)
    ]


@dataclasses.dataclass
class DecodedFile:
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    uids: list
    #: per bag name: (indptr [n+1], key_ids [nnz], vals [nnz], keys [n_keys])
    bags: dict
    #: (rows, key_strs aligned to key ids, val_strs) triplets in order
    meta: tuple


def decode_file(path: str, program: bytes, bag_order: Sequence[str]):
    """Decode one container file natively; None ⇒ caller falls back."""
    lib = _lib()
    if lib is None:
        return None
    dp = lib.pml_avro_decode(
        os.fsencode(str(path)), program, len(program)
    )
    if not dp:
        return None
    try:
        d = dp.contents
        if d.err and d.err != b"":
            return None
        n = int(d.n)
        labels = _arr(d.labels, n, np.float64)
        offsets = _arr(d.offsets, n, np.float64)
        weights = _arr(d.weights, n, np.float64)
        uids: list = [None] * n
        if d.uid_offs:
            uo = _arr(d.uid_offs, n + 1, np.int64)
            if uo[-1] > 0:
                pool = ctypes.string_at(d.uid_pool, int(uo[-1]))
                uids = [
                    pool[uo[i] : uo[i + 1]].decode("utf-8")
                    if uo[i + 1] > uo[i]
                    else None
                    for i in range(n)
                ]
        bags = {}
        for bi, bag_name in enumerate(bag_order):
            indptr = _arr(d.bag_indptr[bi], n + 1, np.int64)
            nnz = int(indptr[-1]) if n else 0
            key_ids = _arr(d.bag_key_ids[bi], nnz, np.int32)
            vals = _arr(d.bag_vals[bi], nnz, np.float64)
            nk = int(d.bag_nkeys[bi])
            koffs = _arr(d.bag_key_offs[bi], nk + 1, np.int64)
            # raw address into C-owned memory (valid until pml_avro_free)
            keys = _pool_strings(d.bag_key_pool[bi] or 0, koffs)
            bags[bag_name] = (indptr, key_ids, vals, keys)
        n_meta = int(d.n_meta)
        meta_rows = _arr(d.meta_row, n_meta, np.int64)
        meta_kid = _arr(d.meta_key_id, n_meta, np.int32)
        nmk = int(d.n_meta_keys)
        mkoffs = _arr(d.meta_key_offs, nmk + 1, np.int64)
        meta_keys = _pool_strings(d.meta_key_pool, mkoffs)
        mvoffs = _arr(d.meta_val_offs, n_meta + 1, np.int64)
        meta_vals = _pool_strings(d.meta_val_pool, mvoffs)
        return DecodedFile(
            labels=labels,
            offsets=offsets,
            weights=weights,
            uids=uids,
            bags=bags,
            meta=(meta_rows, meta_kid, meta_keys, meta_vals),
        )
    finally:
        lib.pml_avro_free(dp)


# ---------------------------------------------------------------------------
# GameData assembly (vectorized — index lookups once per unique key)
# ---------------------------------------------------------------------------


def _resolve_tags(decoded: DecodedFile, id_tags: Sequence[str]):
    """Per requested tag: object array of values; first triplet per row
    wins (top-level string columns are emitted before metadataMap entries,
    preserving ``_record_id_tag`` precedence)."""
    n = len(decoded.labels)
    rows, kids, keys, vals = decoded.meta
    out = {}
    for tag in id_tags:
        col = np.full(n, None, dtype=object)
        # metadataMap entries first, then top-level string columns
        # (\x02-prefixed key space) overwrite them — top-level wins, like
        # the reference's _record_id_tag lookup order
        for key in (tag, "\x02" + tag):
            if key not in keys:
                continue
            kid = keys.index(key)
            sel = np.flatnonzero(kids == kid)
            # reversed ⇒ earlier triplets win within one key space
            for i in sel[::-1]:
                col[rows[i]] = vals[i]
        if any(v is None for v in col):
            raise KeyError(tag)
        out[tag] = col
    return out


def _shard_csr(
    decoded_files: list[DecodedFile],
    bag_names: Sequence[str],
    imap: IndexMap,
    has_intercept: bool,
):
    """Merge bags (record-order: bag1 entries, bag2 …, intercept last) into
    one CSR over the shard's index map, dropping unknown keys."""
    intercept_idx = imap.get_index(INTERCEPT_KEY) if has_intercept else -1
    indptr_parts, idx_parts, val_parts = [], [], []
    for df in decoded_files:
        n = len(df.labels)
        per_bag = []
        for bag in bag_names:
            indptr, key_ids, vals, keys = df.bags[bag]
            gmap = np.fromiter(
                (imap.get_index(k) for k in keys),
                dtype=np.int64,
                count=len(keys),
            )
            g = gmap[key_ids] if len(key_ids) else np.zeros(0, np.int64)
            keep = g >= 0
            counts = np.diff(indptr)
            rows = np.repeat(np.arange(n), counts)
            per_bag.append((rows[keep], g[keep], vals[keep]))
        counts_total = np.zeros(n, dtype=np.int64)
        for rows, _, _ in per_bag:
            counts_total += np.bincount(rows, minlength=n)
        if intercept_idx >= 0:
            counts_total += 1
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts_total, out=indptr[1:])
        nnz = int(indptr[-1])
        indices = np.empty(nnz, dtype=np.int32)
        values = np.empty(nnz, dtype=np.float64)
        fill = indptr[:-1].copy()
        for rows, g, vals in per_bag:
            # entries are row-grouped in order; positions advance per row
            order_pos = fill[rows] + _rank_within(rows)
            indices[order_pos] = g.astype(np.int32)
            values[order_pos] = vals
            fill += np.bincount(rows, minlength=n)
        if intercept_idx >= 0:
            indices[fill] = intercept_idx
            values[fill] = 1.0
        indptr_parts.append(indptr)
        idx_parts.append(indices)
        val_parts.append(values)

    # concatenate files
    base = 0
    out_indptr = [np.zeros(1, dtype=np.int64)]
    for p in indptr_parts:
        out_indptr.append(p[1:] + base)
        base += int(p[-1])
    return (
        np.concatenate(out_indptr),
        np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int32),
        np.concatenate(val_parts) if val_parts else np.zeros(0, np.float64),
    )


def _rank_within(rows: np.ndarray) -> np.ndarray:
    """Position of each entry within its (already grouped) row run."""
    if len(rows) == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    run_ids = np.cumsum(np.r_[True, rows[1:] != rows[:-1]]) - 1
    return np.arange(len(rows)) - starts[run_ids]


def read_game_data_native(
    paths: Sequence[str],
    shard_configs: Mapping,
    id_tags: Sequence[str],
    index_maps: dict,
):
    """Full native read path; returns (GameData, index_maps) or None to
    fall back to the record-dict reader."""
    from photon_tpu_torch.game.data import CSRMatrix, GameData
    from photon_tpu_torch.io.avro import avro_part_files, read_schema

    if _lib() is None:
        return None

    all_bags: list[str] = sorted(
        {b for cfg in shard_configs.values() for b in cfg.feature_bags}
    )
    # one program per distinct schema
    files = [f for p in paths for f in avro_part_files(p)]
    decoded: list[DecodedFile] = []
    for fp in files:
        # fault point: a failed native decode diverts the read to the
        # record decoder with the reason recorded, never aborts it
        faults.fault_point("io.native_decode")
        try:
            compiled = compile_program(read_schema(fp), all_bags)
        except (ValueError, KeyError, OSError):
            return None
        if compiled is None:
            return None
        program, bag_order = compiled
        df = decode_file(fp, program, bag_order)
        if df is None:
            return None
        decoded.append(df)

    labels = np.concatenate([d.labels for d in decoded])
    offsets = np.concatenate([d.offsets for d in decoded])
    weights = np.concatenate([d.weights for d in decoded])
    uids: list = [u for d in decoded for u in d.uids]
    n = len(labels)

    # resolve id tags FIRST — if a tag isn't expressible natively, fail
    # fast to the Python reader before the expensive CSR assembly
    tag_arrays: dict = {t: np.full(n, None, dtype=object) for t in id_tags}
    row0 = 0
    try:
        for d in decoded:
            resolved = _resolve_tags(d, id_tags)
            for t, col in resolved.items():
                tag_arrays[t][row0 : row0 + len(col)] = col
            row0 += len(d.labels)
    except KeyError:
        return None  # tag not expressible natively → Python reader decides

    # generate missing index maps from the per-file key vocabularies
    for shard, cfg in shard_configs.items():
        if shard in index_maps:
            continue
        keys: set = set()
        for d in decoded:
            for bag in cfg.feature_bags:
                keys.update(d.bags[bag][3])
        index_maps[shard] = DefaultIndexMap.from_keys(
            keys, add_intercept=cfg.has_intercept
        )

    feature_shards = {}
    for shard, cfg in shard_configs.items():
        indptr, indices, values = _shard_csr(
            decoded, cfg.feature_bags, index_maps[shard], cfg.has_intercept
        )
        feature_shards[shard] = CSRMatrix(
            indptr=indptr,
            indices=indices,
            values=values,
            num_cols=len(index_maps[shard]),
        )

    return (
        GameData.build(
            labels=labels,
            feature_shards=feature_shards,
            offsets=offsets,
            weights=weights,
            id_tags=tag_arrays,
            uids=uids,
        ),
        index_maps,
    )
