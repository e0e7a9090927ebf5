"""Packed columnar feature cache: the write-once mmap ingest tier.

Counterpart of photon_tpu/cache. Every training and scoring run pays the
Avro decode and host assembly again; this package materializes a dataset
once into a versioned, memory-mapped columnar store (``cache.format``,
``cache.writer``) and replays it on later runs with no Avro decode
(``cache.reader``): the streaming scorer's producer becomes an mmap
slice. A cache either package writes is one the other opens, and both
resolve the same ``default_cache_dir`` for the same inputs.

The front door is :func:`resolve_reader`: a call site hands it what it
would hand ``AvroDataReader`` and gets back a reader with the same
``read`` / ``iter_chunks`` contract, resolved by mode
(``PHOTON_FEATURE_CACHE`` env > explicit argument > ``off``):

``off``      the avro path, untouched (the default);
``use``      replay a fresh cache when one exists (state ``hit``), else
             read avro AND build the cache from the same decode: run 1 is
             the cold build, run 2 is warm;
``rebuild``  force a fresh build even over a valid cache;
``require``  refuse to run without a fresh cache
             (:class:`FeatureCacheRequiredError` names the cache tool).

Degrade discipline: a cache that is missing, torn (size or checksum
mismatch; ``PHOTON_FEATURE_CACHE_VERIFY=1`` rechecks the sha256s at open)
or stale (source files, shard configs, id tags or index maps changed)
falls back to the avro path with a logged warning, never to wrong rows;
``require`` raises instead. Fault points ``cache.open`` / ``cache.read``
/ ``cache.write`` / ``cache.replace`` inject each leg.

Counters, with the JAX package's names: ``cache.hit``, ``cache.miss``,
``cache.stale``, ``cache.fallback`` (with lifecycle events), and the
writer's ``cache.write_rows``, ``cache.build``, ``cache.build_bytes`` and
``cache.build_failed``.

Per-process ingest shards (:func:`ingest_shard`): every process of a
multi-process run reads its own round-robin subset of the part files, so
a fleet decodes each byte once. The subset is taken on the file list
before the cache directory's key and the source fingerprint are computed,
so the cold Avro read and the warm mmap replay split the same way and
each shard has a cache of its own. A meshed fit needs the whole input on
every rank (parallel/distributed.py); its driver passes ``shard=(0, 1)``.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Iterator, Mapping, Sequence

from photon_tpu_torch.cache.format import (
    CACHE_FORMAT_VERSION,
    MANIFEST,
    CacheCorruptError,
    CacheError,
    CacheStaleError,
    FeatureCacheRequiredError,
    canonical_json,
    shard_config_fingerprint,
    source_file_fingerprint,
)
from photon_tpu_torch.cache.reader import CachedDataReader
from photon_tpu_torch.cache.writer import (
    FeatureCacheWriter,
    build_through,
    report_build_failure,
    write_game_data,
)
from photon_tpu_torch import obs
from photon_tpu_torch.game.data import GameData

__all__ = [
    "CACHE_FORMAT_VERSION",
    "CacheCorruptError",
    "CacheError",
    "CacheStaleError",
    "CachedDataReader",
    "FeatureCacheRequiredError",
    "FeatureCacheWriter",
    "MANIFEST",
    "MODES",
    "ResolvedReader",
    "cache_mode",
    "default_cache_dir",
    "ingest_shard",
    "list_source_files",
    "resolve_reader",
    "shard_paths",
    "verify_on_open",
    "write_game_data",
]

logger = logging.getLogger(__name__)

MODES = ("off", "use", "require", "rebuild")

#: the errors the front door absorbs into an avro fallback; anything else
#: (a programming error, an injected crash) propagates
_DEGRADABLE = (CacheError, OSError, ValueError, KeyError)


def cache_mode(config_value: str | None = None) -> str:
    """The feature-cache mode: ``PHOTON_FEATURE_CACHE`` env > the given
    value > ``off``. An invalid value raises up front."""
    env = os.environ.get("PHOTON_FEATURE_CACHE", "").strip()
    v = env or (config_value or "off")
    if v not in MODES:
        raise ValueError(f"feature-cache mode must be one of {'/'.join(MODES)}, got {v!r}")
    return v


def verify_on_open() -> bool:
    """``PHOTON_FEATURE_CACHE_VERIFY=1``: recheck every column's sha256 at
    open (O(cache bytes); size checks always run)."""
    env = os.environ.get("PHOTON_FEATURE_CACHE_VERIFY", "").strip()
    if env and env not in ("0", "1"):
        raise ValueError(f"PHOTON_FEATURE_CACHE_VERIFY must be 0 or 1, got {env!r}")
    return env == "1"


def default_cache_dir(paths: Sequence[str], shard_configs: Mapping, id_tags: Sequence[str]) -> str:
    """Where a dataset's cache lives without an explicit directory:
    ``<cache root>/<key>``, keyed on the schema (shard configs, id tags,
    format version) and the PATH SET. A different file set gets another
    directory (a miss, then a build); the same paths with changed content
    resolve to the same directory and fail its fingerprint (stale). The
    root is ``<data base>/_photon_cache``, or ``PHOTON_FEATURE_CACHE_DIR``
    (the key still appends, so training and validation keep separate
    caches)."""
    key_src = canonical_json(
        {
            "format_version": CACHE_FORMAT_VERSION,
            "shard_configs": shard_config_fingerprint(shard_configs),
            "id_tags": sorted(id_tags),
            "paths": sorted(os.path.abspath(str(p)) for p in paths),
        }
    )
    key = hashlib.sha256(key_src.encode("utf-8")).hexdigest()[:16]
    env = os.environ.get("PHOTON_FEATURE_CACHE_DIR", "").strip()
    if env:
        return os.path.join(env, key)
    first = str(paths[0])
    base = first if os.path.isdir(first) else (os.path.dirname(first) or ".")
    return os.path.join(base, "_photon_cache", key)


def ingest_shard() -> tuple[int, int]:
    """This process's disjoint ingest shard ``(index, count)``.

    Every process of a multi-process run runs the same driver on the same
    input paths; without a shard each would decode (or replay) the whole
    dataset. Resolution: ``PHOTON_INGEST_SHARD`` (``"i/n"``, the test
    lever and the override for launchers that shard upstream; ``"off"``
    turns selection off), else the live ``torch.distributed`` world when
    one is initialized with more than one rank (read only: finding out
    never initializes a group), else ``(0, 1)``.

    Contract boundary: disjoint ingest pairs with per-process fits (a
    streaming fit, ``mesh=None``). A meshed fit follows
    ``parallel.distributed.distribute_batch``'s contract instead (the same
    global data on every rank, each keeping its rows) and must read with
    ``shard=(0, 1)``, ``PHOTON_INGEST_SHARD=off``'s meaning: disjoint rows
    would make every rank's "global" data disagree."""
    env = os.environ.get("PHOTON_INGEST_SHARD", "").strip()
    if env.lower() == "off":
        return 0, 1
    if env:
        idx_s, sep, n_s = env.partition("/")
        try:
            idx, n = int(idx_s), int(n_s)
        except ValueError:
            idx, n = -1, 0
        if not sep or n < 1 or not (0 <= idx < n):
            raise ValueError(f"PHOTON_INGEST_SHARD must be 'i/n' with 0 <= i < n, got {env!r}")
        return idx, n
    return obs.fleet.live_world()


def list_source_files(paths: Sequence[str], shard: tuple[int, int] | None = None) -> list[str]:
    """THE avro part-file enumeration of the cache layer (front door,
    fingerprint, cache tool): the staleness verdict and a build's
    fingerprint describe the same file list.

    ``shard=(i, n)`` keeps this process's round-robin subset (``files[i::n]``
    of the sorted enumeration); selecting here, on the file list, makes
    the cold Avro path and the warm cache path (whose key and fingerprint
    derive from this list) split the same way."""
    from photon_tpu_torch.io.avro import avro_part_files

    files = [f for p in paths for f in avro_part_files(p)]
    if shard is None or shard[1] <= 1:
        return files
    idx, n = shard
    selected = files[idx::n]
    if not selected:
        raise ValueError(
            f"ingest shard {idx}/{n} selects 0 of {len(files)} part "
            "files — fewer part files than processes; repartition the "
            "input or run fewer processes"
        )
    return selected


def shard_paths(paths: Sequence[str], shard: tuple[int, int] | None = None):
    """``(paths, shard)``: ``paths`` narrowed to this process's ingest shard
    (``shard``, else :func:`ingest_shard`), as given when unsharded. Every
    cache key and fingerprint is computed from the narrowed list, so the
    cold avro read, the warm replay and a cache build (cli/cache_tool.py)
    all describe the same disjoint rows and key to the same directory."""
    shard = ingest_shard() if shard is None else shard
    if shard[1] > 1:
        paths = list_source_files(paths, shard=shard)
        logger.info("ingest shard %d/%d: %d part files", shard[0], shard[1], len(paths))
    return paths, shard


def _fallback(reason: str, detail: str) -> None:
    obs.counter("cache.fallback")
    obs.instant("cache.fallback", cat="lifecycle", reason=reason, error=detail)
    logger.warning("feature cache unusable (%s: %s); degrading to the avro path", reason, detail)


class ResolvedReader:
    """What :func:`resolve_reader` returns: the ``read`` / ``iter_chunks``
    contract of ``AvroDataReader``, served from the cache on a hit and
    from avro (with an opportunistic build-through) otherwise."""

    def __init__(
        self,
        *,
        mode: str,
        state: str,
        paths: Sequence[str],
        shard_configs: Mapping,
        id_tags: Sequence[str],
        cache_dir: str | None,
        cached: CachedDataReader | None,
        index_maps: Mapping | None,
        source_files: list | None = None,
        source_fingerprint: list | None = None,
    ):
        self.mode = mode
        self.state = state  # off | hit | miss | stale | corrupt
        self.paths = list(paths)
        self.shard_configs = dict(shard_configs)
        self.id_tags = tuple(id_tags)
        self.cache_dir = cache_dir
        self._cached = cached
        self._avro = None
        self._caller_maps = dict(index_maps) if index_maps else None
        self._source_files_cached = source_files
        self._source_fingerprint = source_fingerprint
        self._built = False

    @property
    def source(self) -> str:
        return "cache" if self._cached is not None else "avro"

    @property
    def index_maps(self) -> dict:
        """The maps this dataset resolves features with: the caller's,
        enriched by an avro read, or the cache's own on a mapless hit."""
        if self._avro is not None:
            return self._avro.index_maps
        if self._caller_maps:
            return dict(self._caller_maps)
        if self._cached is not None:
            return self._cached.index_maps_for(list(self.shard_configs))
        return {}

    @property
    def decoder(self) -> dict:
        """Which decoder served the data: ``cache`` for a replay, else the
        Avro reader's ``last_decoder`` and its reason (None before a read)."""
        if self._avro is None:
            return {"decoder": "cache" if self._cached is not None else None, "reason": None}
        return {"decoder": self._avro.last_decoder, "reason": self._avro.last_decoder_reason}

    def describe(self) -> dict:
        return {"mode": self.mode, "source": self.source, "state": self.state,
                "cacheDir": self.cache_dir}

    def _avro_reader(self):
        from photon_tpu_torch.io.data_reader import AvroDataReader

        if self._avro is None:
            self._avro = AvroDataReader(index_maps=self._caller_maps)
        return self._avro

    def _source_files(self) -> list[str]:
        if self._source_files_cached is None:
            self._source_files_cached = list_source_files(self.paths)
        return self._source_files_cached

    def _should_build(self) -> bool:
        return (
            self.mode in ("use", "rebuild")
            and self._cached is None
            and not self._built
            and self.cache_dir is not None
        )

    def _degrade(self, stage: str, exc: BaseException) -> None:
        """Drop a cache that failed mid-use (``require`` never degrades:
        the operator asked for the cache or a loud failure)."""
        if self.mode == "require":
            raise FeatureCacheRequiredError(
                f"feature cache {self.cache_dir} failed during {stage} "
                f"({type(exc).__name__}: {exc}) and require mode forbids the avro "
                "fallback; rebuild and verify it with python -m "
                "photon_tpu_torch.cli.cache_tool"
            ) from exc
        _fallback(stage, f"{type(exc).__name__}: {exc}")
        self._cached = None
        self.state = "corrupt"

    def read(self) -> GameData:
        """One GameData for the whole dataset. On a hit an mmap replay; on
        a miss in ``use``/``rebuild`` mode the avro read also builds the
        cache for the next run (no second decode)."""
        if self._cached is not None:
            try:
                return self._cached.read_all(self.shard_configs, self.id_tags)
            except _DEGRADABLE as e:
                self._degrade("read", e)
        reader = self._avro_reader()
        data = reader.read(self.paths, self.shard_configs, id_tags=self.id_tags)
        if self._should_build():
            self._built = True
            try:
                write_game_data(
                    self.cache_dir,
                    data,
                    shard_configs=self.shard_configs,
                    id_tags=self.id_tags,
                    source_files=self._source_files(),
                    source_fingerprint=self._source_fingerprint,
                    index_maps=reader.index_maps,
                )
            except Exception as e:
                report_build_failure("write", e)
        return data

    def _replay_with_fallback(self, chunk_rows: int) -> Iterator[GameData]:
        """Cache replay that keeps the degrade promise mid-stream: a
        failure after k chunks resumes the avro path past the k chunks
        already delivered (chunk boundaries depend on ``chunk_rows`` only),
        so the consumer sees one duplicate-free stream."""
        yielded = 0
        try:
            for chunk in self._cached.iter_chunks(
                self.shard_configs, self.id_tags, chunk_rows=chunk_rows
            ):
                yield chunk
                yielded += 1
        except _DEGRADABLE as e:
            if self._caller_maps is None:
                # a mapless consumer was served the cache's stored maps;
                # the avro resume needs them too, and if the tear reaches
                # the map columns there is none: propagate the original
                try:
                    self._caller_maps = self._cached.index_maps_for(list(self.shard_configs))
                except _DEGRADABLE:
                    raise e from None
            self._degrade("replay", e)
            # no build-through on the resumed stream: its first k chunks
            # were never appended
            for i, chunk in enumerate(
                self._avro_reader().iter_chunks(
                    self.paths, self.shard_configs, id_tags=self.id_tags, chunk_rows=chunk_rows
                )
            ):
                if i >= yielded:
                    yield chunk

    def iter_chunks(self, chunk_rows: int = 8192) -> Iterator[GameData]:
        """Streamed GameData chunks. A hit slices the mmap at any chunk
        size; a miss streams avro and builds the cache through it."""
        if self._cached is not None:
            return self._replay_with_fallback(chunk_rows)
        reader = self._avro_reader()
        chunks = reader.iter_chunks(
            self.paths, self.shard_configs, id_tags=self.id_tags, chunk_rows=chunk_rows
        )
        if not self._should_build():
            return chunks
        self._built = True
        try:
            writer = FeatureCacheWriter(
                self.cache_dir,
                shard_configs=self.shard_configs,
                id_tags=self.id_tags,
                source_files=self._source_files(),
                source_fingerprint=self._source_fingerprint,
            )
        except Exception as e:
            report_build_failure("writer-construction", e)
            return chunks
        return build_through(chunks, writer, index_maps_fn=lambda: reader.index_maps)


def resolve_reader(
    paths,
    shard_configs: Mapping,
    *,
    index_maps: Mapping | None = None,
    id_tags: Sequence[str] = (),
    mode: str | None = None,
    shard: tuple[int, int] | None = None,
) -> ResolvedReader:
    """The ingest front door: resolve (paths, schema) to a cache replay or
    the avro path by mode (see the module docstring). ``shard`` overrides
    :func:`ingest_shard` (a meshed fit passes ``(0, 1)``)."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    paths, _ = shard_paths(paths, shard)
    mode = cache_mode(mode)
    if mode == "off":
        return ResolvedReader(
            mode=mode, state="off", paths=paths, shard_configs=shard_configs,
            id_tags=id_tags, cache_dir=None, cached=None, index_maps=index_maps,
        )
    cdir = default_cache_dir(paths, shard_configs, id_tags)
    verify = verify_on_open()  # the knob is validated hit or miss
    cached = None
    state = "miss"
    src_files: list | None = None
    src_fp: list | None = None
    if mode != "rebuild" and os.path.exists(os.path.join(cdir, MANIFEST)):
        try:
            candidate = CachedDataReader(cdir, verify_checksums=verify)
            src_files = list_source_files(paths)
            # hash the sources once: the verdict here and, on a rebuild,
            # the new manifest use the same fingerprint
            src_fp = source_file_fingerprint(src_files)
            candidate.raise_if_stale(
                src_files, shard_configs, id_tags, index_maps, source_fingerprint=src_fp
            )
            cached, state = candidate, "hit"
        except CacheStaleError as e:
            state = "stale"
            obs.counter("cache.stale")
            _fallback("stale", str(e))
        except _DEGRADABLE as e:
            state = "corrupt"
            _fallback("open", f"{type(e).__name__}: {e}")
    if cached is not None:
        obs.counter("cache.hit")
        obs.instant("cache.hit", cat="lifecycle", dir=cdir)
    elif state == "miss" and mode != "require":
        obs.counter("cache.miss")
    if cached is None and mode == "require":
        raise FeatureCacheRequiredError(
            f"feature cache mode require but no fresh feature cache at {cdir} "
            f"(state: {state}). Build and verify one with: python -m "
            f"photon_tpu_torch.cli.cache_tool build ... && python -m "
            f"photon_tpu_torch.cli.cache_tool verify {cdir}"
        )
    return ResolvedReader(
        mode=mode, state=state, paths=paths, shard_configs=shard_configs, id_tags=id_tags,
        cache_dir=cdir, cached=cached, index_maps=index_maps, source_files=src_files,
        source_fingerprint=src_fp,
    )
