"""Port parity of the packed columnar feature cache (photon_tpu_torch.cache).

On uneven Avro part files (test_cache's ``_write_parts``): a cache
replays bit for bit what the Avro reader of either package reads, whole
and in chunks; a cache either package builds is byte-identical to the
other's and replays in the other to equal GameData; both resolve the same
``default_cache_dir``. Then the front door's modes (off, use, rebuild,
require), the stale legs (files, shard configs, id tags, index maps), the
torn legs (a truncated column, a checksum mismatch under verify), the
``cache.*`` fault points (a mid-stream replay failure resumes the Avro
path chunk-aligned), the cache tool, and the warm cache feeding
``GameScorer.stream`` with no Avro decode.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from photon_tpu import cache as jcache
from photon_tpu.io.data_reader import AvroDataReader as JReader
from photon_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_tpu_torch import cache as tcache
from photon_tpu_torch.cache import (
    CachedDataReader,
    FeatureCacheRequiredError,
    cache_mode,
    default_cache_dir,
    resolve_reader,
)
from photon_tpu_torch.cache.format import MANIFEST
from photon_tpu_torch.cli import cache_tool
from photon_tpu_torch.game.data import slice_game_data
from photon_tpu_torch.io.data_reader import AvroDataReader
from photon_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_tpu_torch.util import faults
from test_cache import _write_parts

SHARDS = {"g": TShard(feature_bags=("features",), has_intercept=False)}
J_SHARDS = {"g": JShard(feature_bags=("features",), has_intercept=False)}
TAGS = ("userId",)
SHARD_ARG = "name=g,feature.bags=features,intercept=false"


def _avro_maps(directory):
    reader = AvroDataReader()
    ref = reader.read(directory, SHARDS, id_tags=TAGS)
    return ref, reader.index_maps


def _assert_game_data_equal(a, b):
    """Bit-for-bit equality of two GameData (of either package)."""
    for col in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(a, col), getattr(b, col)), col
        assert np.asarray(getattr(b, col)).dtype == np.float64
    assert set(a.feature_shards) >= set(b.feature_shards)
    for name in b.feature_shards:
        ma, mb = a.feature_shards[name], b.feature_shards[name]
        assert ma.num_cols == mb.num_cols
        assert np.array_equal(ma.indptr, mb.indptr)
        assert np.array_equal(ma.indices, mb.indices)
        assert np.array_equal(ma.values, mb.values)
    for tag in b.id_tags:
        assert list(a.id_tags[tag]) == list(b.id_tags[tag])
    if a.uids is None or b.uids is None:
        assert a.uids == b.uids
    else:
        assert list(a.uids) == list(b.uids)


def _cache_manifests(data_dir):
    root = os.path.join(data_dir, "_photon_cache")
    if not os.path.isdir(root):
        return []
    return [
        os.path.join(root, e, MANIFEST)
        for e in os.listdir(root)
        if ".tmp-" not in e and ".old-" not in e
        and os.path.exists(os.path.join(root, e, MANIFEST))
    ]


@pytest.fixture()
def dataset(tmp_path):
    d = str(tmp_path / "data")
    _write_parts(d)  # n = 41 over parts of 5, 3, 16, 9, 8 rows
    ref, maps = _avro_maps(d)
    return d, ref, maps


# --- parity ------------------------------------------------------------------


def test_cold_build_then_warm_read_is_bit_identical(dataset):
    d, ref, maps = dataset
    _assert_game_data_equal(ref, JReader().read(d, J_SHARDS, id_tags=TAGS))
    cold = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert cold.state == "miss"
    _assert_game_data_equal(ref, cold.read())
    warm = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert warm.state == "hit" and warm.source == "cache"
    data = warm.read()
    assert data.provenance == {"source": "cache", "dir": warm.cache_dir}
    assert warm.decoder == {"decoder": "cache", "reason": None}
    _assert_game_data_equal(ref, data)


@pytest.mark.parametrize("chunk_rows", [4, 7, 16, 100])
def test_iter_chunks_parity_across_uneven_part_files(dataset, chunk_rows):
    """The teed cold chunks, the warm replay's chunks and both packages'
    Avro chunks are one and the same stream."""
    d, _, maps = dataset
    avro_chunks = list(AvroDataReader(index_maps=dict(maps)).iter_chunks(
        d, SHARDS, id_tags=TAGS, chunk_rows=chunk_rows))
    jax_chunks = list(JReader(index_maps=dict(maps)).iter_chunks(
        d, J_SHARDS, id_tags=TAGS, chunk_rows=chunk_rows))
    teed = list(resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
                .iter_chunks(chunk_rows=chunk_rows))
    warm = list(resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="require")
                .iter_chunks(chunk_rows=chunk_rows))
    assert len(avro_chunks) == len(jax_chunks) == len(teed) == len(warm) == -(-41 // chunk_rows)
    for a, j, t, w in zip(avro_chunks, jax_chunks, teed, warm):
        _assert_game_data_equal(j, a)
        _assert_game_data_equal(a, t)
        _assert_game_data_equal(a, w)
        assert w.provenance["source"] == "cache" and t.provenance is None


def test_iter_chunks_fixed_rows_partial_tail(dataset):
    """Fixed-row chunks with a short tail, each equal to the same rows of
    ``read_all``, whatever ``chunk_rows`` divides."""
    d, _, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    reader = CachedDataReader(default_cache_dir([d], SHARDS, TAGS))
    whole = reader.read_all(SHARDS, id_tags=TAGS)
    for rows, sizes in ((16, [16, 16, 9]), (41, [41]), (7, [7] * 5 + [6])):
        chunks = list(reader.iter_chunks(SHARDS, id_tags=TAGS, chunk_rows=rows))
        assert [c.num_samples for c in chunks] == sizes
        for k, c in enumerate(chunks):
            lo = k * rows
            _assert_game_data_equal(slice_game_data(whole, lo, lo + c.num_samples), c)
            assert c.provenance["source"] == "cache"
    with pytest.raises(ValueError, match="chunk_rows"):
        next(reader.iter_chunks(SHARDS, id_tags=TAGS, chunk_rows=0))


def test_unseen_entity_keys_round_trip(tmp_path):
    d = str(tmp_path / "data")
    _write_parts(d, part_sizes=(21, 20), unseen_prefix="never-seen:é-")
    ref, maps = _avro_maps(d)
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    warm = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="require").read()
    _assert_game_data_equal(ref, warm)
    assert all(k.startswith("never-seen:é-") for k in warm.id_tags["userId"])


def test_mapless_warm_run_gets_cached_index_maps(dataset):
    d, ref, maps = dataset
    resolve_reader(d, SHARDS, id_tags=TAGS, mode="use").read()  # cold: generates
    warm = resolve_reader(d, SHARDS, id_tags=TAGS, mode="require")
    got = warm.index_maps["g"]
    assert len(got) == len(maps["g"])
    for key, idx in maps["g"]:
        assert got.get_index(key) == idx
    _assert_game_data_equal(ref, warm.read())


# --- across the packages -----------------------------------------------------


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_a_cache_either_package_builds_replays_in_the_other(dataset, maker):
    """The cold build of one package is opened warm by the other (read and
    chunks), and the two packages' builds of the same data are the same
    bytes: equal column checksums and fingerprints."""
    d, ref, maps = dataset
    jr = jcache.resolve_reader(d, J_SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    tr = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert jr.cache_dir == tr.cache_dir
    first, second = (jcache, J_SHARDS), (tcache, SHARDS)
    if maker == "port":
        first, second = second, first
    first[0].resolve_reader(d, first[1], index_maps=maps, id_tags=TAGS, mode="use").read()
    built = json.load(open(os.path.join(tr.cache_dir, MANIFEST)))
    warm = second[0].resolve_reader(d, second[1], index_maps=maps, id_tags=TAGS,
                                    mode="require")
    assert warm.state == "hit"
    _assert_game_data_equal(ref, warm.read())
    for a, b in zip(AvroDataReader(index_maps=dict(maps)).iter_chunks(
            d, SHARDS, id_tags=TAGS, chunk_rows=8), warm.iter_chunks(chunk_rows=8)):
        _assert_game_data_equal(a, b)
    # the other package rebuilds the same cache byte for byte
    second[0].resolve_reader(d, second[1], index_maps=maps, id_tags=TAGS, mode="rebuild").read()
    rebuilt = json.load(open(os.path.join(tr.cache_dir, MANIFEST)))
    for key in ("columns", "fingerprint", "fingerprint_sha256", "shards", "num_samples"):
        assert rebuilt[key] == built[key], key


def test_both_packages_resolve_the_same_cache_dir(tmp_path, monkeypatch):
    paths = [str(tmp_path / "a"), str(tmp_path / "b" / "part-00000.avro")]
    os.makedirs(paths[0])
    for tags in ((), ("userId", "itemId")):
        assert default_cache_dir(paths, SHARDS, tags) == jcache.default_cache_dir(
            paths, J_SHARDS, tags)
    assert default_cache_dir(paths, SHARDS, TAGS).startswith(
        os.path.join(paths[0], "_photon_cache") + os.sep)
    monkeypatch.setenv("PHOTON_FEATURE_CACHE_DIR", str(tmp_path / "root"))
    got = default_cache_dir(paths, SHARDS, TAGS)
    assert got == jcache.default_cache_dir(paths, J_SHARDS, TAGS)
    assert os.path.dirname(got) == str(tmp_path / "root")


# --- modes and knobs -----------------------------------------------------------


def test_mode_off_touches_no_cache(dataset):
    d, ref, maps = dataset
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="off")
    assert (r.state, r.cache_dir) == ("off", None)
    _assert_game_data_equal(ref, r.read())
    assert r.decoder == {"decoder": "native", "reason": None}
    assert not os.path.exists(os.path.join(d, "_photon_cache"))


def test_env_mode_wins_and_bad_values_raise(dataset, monkeypatch):
    d, _, maps = dataset
    monkeypatch.setenv("PHOTON_FEATURE_CACHE", "off")
    assert cache_mode("use") == "off"
    monkeypatch.setenv("PHOTON_FEATURE_CACHE", "banana")
    with pytest.raises(ValueError, match="banana"):
        resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS)
    monkeypatch.delenv("PHOTON_FEATURE_CACHE")
    monkeypatch.setenv("PHOTON_FEATURE_CACHE_VERIFY", "2")
    with pytest.raises(ValueError, match="VERIFY"):
        resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")


def test_ingest_shard_resolves_one_shard(monkeypatch):
    """The name dates from when the port had one shard only; ``"1/2"`` is
    now JAX's ``(1, 2)``."""
    for value in ("", "off", "0/1"):
        monkeypatch.setenv("PHOTON_INGEST_SHARD", value)
        assert tcache.ingest_shard() == (0, 1)
    for bad in ("1/1", "2", "a/b", "-1/2"):
        monkeypatch.setenv("PHOTON_INGEST_SHARD", bad)
        with pytest.raises(ValueError, match="PHOTON_INGEST_SHARD"):
            tcache.ingest_shard()
    monkeypatch.setenv("PHOTON_INGEST_SHARD", "1/2")
    assert tcache.ingest_shard() == jcache.ingest_shard() == (1, 2)


def test_env_cache_dir_is_a_root_keeping_datasets_separate(dataset, tmp_path, monkeypatch):
    d_train, ref, maps = dataset
    d_valid = str(tmp_path / "valid")
    _write_parts(d_valid, seed=7, part_sizes=(11, 30))
    ref_valid, maps_valid = _avro_maps(d_valid)
    monkeypatch.setenv("PHOTON_FEATURE_CACHE_DIR", str(tmp_path / "croot"))
    for d, m in ((d_train, maps), (d_valid, maps_valid)):
        resolve_reader(d, SHARDS, index_maps=m, id_tags=TAGS, mode="use").read()
    warm_train = resolve_reader(d_train, SHARDS, index_maps=maps, id_tags=TAGS, mode="require")
    warm_valid = resolve_reader(d_valid, SHARDS, index_maps=maps_valid, id_tags=TAGS,
                                mode="require")
    assert warm_train.state == warm_valid.state == "hit"
    assert warm_train.cache_dir != warm_valid.cache_dir
    _assert_game_data_equal(ref, warm_train.read())
    _assert_game_data_equal(ref_valid, warm_valid.read())
    assert not os.path.exists(os.path.join(d_train, "_photon_cache"))


def test_require_without_cache_points_at_cache_tool(dataset):
    d, _, maps = dataset
    with pytest.raises(FeatureCacheRequiredError, match="cache_tool"):
        resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="require")


def test_rebuild_replaces_a_fresh_cache(dataset):
    d, ref, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    first = json.load(open(_cache_manifests(d)[0]))["created_unix"]
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="rebuild")
    assert (r.state, r.source) == ("miss", "avro")
    _assert_game_data_equal(ref, r.read())
    (manifest,) = _cache_manifests(d)
    assert json.load(open(manifest))["created_unix"] > first


def test_stale_by_files_degrades_then_rebuilds(dataset):
    d, _, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    _write_parts(d, seed=99)  # new content at the same paths
    ref2, maps2 = _avro_maps(d)
    stale = resolve_reader(d, SHARDS, index_maps=maps2, id_tags=TAGS, mode="use")
    assert stale.state == "stale"
    _assert_game_data_equal(ref2, stale.read())  # avro, then a rebuild
    warm = resolve_reader(d, SHARDS, index_maps=maps2, id_tags=TAGS, mode="require")
    assert warm.state == "hit"
    _assert_game_data_equal(ref2, warm.read())
    _write_parts(d, seed=123)
    with pytest.raises(FeatureCacheRequiredError, match="stale"):
        resolve_reader(d, SHARDS, index_maps=maps2, id_tags=TAGS, mode="require")


def test_stale_by_shard_config_id_tags_and_index_maps(dataset):
    """A cache is stale for a shard config, an id tag or an index map it
    was not built with; the reader names which."""
    from photon_tpu_torch.data.index_map import DefaultIndexMap

    d, ref, maps = dataset
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    r.read()
    cached = CachedDataReader(r.cache_dir)
    files = tcache.list_source_files([d])
    assert cached.validate_sources(files, SHARDS, TAGS, maps) == []
    other = {"g": TShard(feature_bags=("features",), has_intercept=True)}
    assert cached.validate_sources(files, other, TAGS) == ["feature shard config 'g' changed"]
    assert cached.validate_sources(files, SHARDS, ("userId", "itemId")) == [
        "id tags ['itemId'] not cached"]
    keys = [k for k, _ in sorted(maps["g"], key=lambda kv: kv[1])]
    shuffled = {"g": DefaultIndexMap({k: i for i, k in enumerate(reversed(keys))})}
    assert cached.validate_sources(files, SHARDS, TAGS, shuffled) == [
        "index map for shard 'g' changed"]
    # through the front door: index maps are not part of the directory key
    stale = resolve_reader(d, SHARDS, index_maps=shuffled, id_tags=TAGS, mode="use")
    assert (stale.state, stale.cache_dir) == ("stale", r.cache_dir)
    # a shard config is: move the cache to the other config's directory
    other_dir = tcache.default_cache_dir([d], other, TAGS)
    assert other_dir != r.cache_dir
    shutil.move(r.cache_dir, other_dir)
    with pytest.raises(FeatureCacheRequiredError, match="stale"):
        resolve_reader(d, other, index_maps=maps, id_tags=TAGS, mode="require")


# --- fault legs ----------------------------------------------------------------


def test_write_fault_mid_column_never_publishes_then_rebuilds(dataset):
    d, _, maps = dataset
    with faults.injected("cache.write@3=io_error"):
        r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
        chunks = list(r.iter_chunks(chunk_rows=8))  # the stream survives
    assert len(chunks) == 6
    assert _cache_manifests(d) == []
    assert os.listdir(os.path.join(d, "_photon_cache")) == []  # no tmp dropping
    r2 = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert r2.state == "miss"
    cold = list(r2.iter_chunks(chunk_rows=8))
    r3 = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="require")
    for a, b in zip(cold, r3.iter_chunks(chunk_rows=8)):
        _assert_game_data_equal(a, b)


def test_open_fault_degrades_to_avro(dataset):
    d, ref, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    with faults.injected("cache.open@1=io_error"):
        r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert (r.state, r.source) == ("corrupt", "avro")
    _assert_game_data_equal(ref, r.read())


def test_mid_stream_replay_fault_resumes_avro_chunk_aligned(dataset):
    d, _, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    ref_chunks = list(AvroDataReader(index_maps=dict(maps)).iter_chunks(
        d, SHARDS, id_tags=TAGS, chunk_rows=8))
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert r.state == "hit"
    with faults.injected("cache.read@3=io_error"):
        got = list(r.iter_chunks(chunk_rows=8))
    assert len(got) == len(ref_chunks) == 6
    for a, b in zip(ref_chunks, got):
        _assert_game_data_equal(a, b)
    assert [c.provenance is not None for c in got] == [True, True, False, False, False, False]
    assert r.state == "corrupt"
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="require")
    with faults.injected("cache.read@2=io_error"):
        with pytest.raises(FeatureCacheRequiredError, match="replay"):
            list(r.iter_chunks(chunk_rows=8))


def test_mapless_mid_stream_fault_resumes_with_cached_maps(dataset):
    d, _, maps = dataset
    resolve_reader(d, SHARDS, id_tags=TAGS, mode="use").read()
    ref_chunks = list(AvroDataReader(index_maps=dict(maps)).iter_chunks(
        d, SHARDS, id_tags=TAGS, chunk_rows=8))
    r = resolve_reader(d, SHARDS, id_tags=TAGS, mode="use")
    assert r.state == "hit"
    with faults.injected("cache.read@2=io_error"):
        got = list(r.iter_chunks(chunk_rows=8))
    assert len(got) == len(ref_chunks)
    for a, b in zip(ref_chunks, got):
        _assert_game_data_equal(a, b)


def test_checksum_mismatch_degrades_under_verify(dataset, monkeypatch):
    d, ref, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    col = os.path.join(os.path.dirname(_cache_manifests(d)[0]), "labels.f64")
    blob = bytearray(open(col, "rb").read())
    blob[5] ^= 0xFF  # same size: only the sha256 sees it
    with open(col, "wb") as f:
        f.write(bytes(blob))
    assert resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").state == "hit"
    monkeypatch.setenv("PHOTON_FEATURE_CACHE_VERIFY", "1")
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert r.state == "corrupt"
    _assert_game_data_equal(ref, r.read())


@pytest.mark.parametrize("column", ["weights.f64", "shard.g.values.f64"])
def test_truncated_column_detected_without_verify(dataset, column):
    d, ref, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    col = os.path.join(os.path.dirname(_cache_manifests(d)[0]), column)
    blob = open(col, "rb").read()
    with open(col, "wb") as f:
        f.write(blob[:-8])
    r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use")
    assert r.state == "corrupt"
    _assert_game_data_equal(ref, r.read())  # avro, then a rebuild
    assert resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="require").state == "hit"


def test_crash_in_publish_window_leaves_old_or_none(dataset):
    d, _, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    with faults.injected("cache.replace@1=crash"):
        with pytest.raises(faults.InjectedCrash):
            resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="rebuild").read()
    manifests = _cache_manifests(d)
    assert len(manifests) <= 1
    for m in manifests:
        CachedDataReader(os.path.dirname(m), verify_checksums=True)
    # the next writer sweeps the killed one's droppings
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="rebuild").read()
    root = os.path.join(d, "_photon_cache")
    assert [e for e in os.listdir(root) if ".tmp-" in e or ".old-" in e] == []


# --- the cache tool -------------------------------------------------------------


def test_cache_tool_build_inspect_verify_and_torn_exit(dataset, capsys):
    d, ref, maps = dataset
    assert cache_tool.run(["build", "--input-data-directories", d,
                           "--feature-shard-configurations", SHARD_ARG, "--id-tags", "userId",
                           "--chunk-rows", "8"]) == 0
    (manifest,) = _cache_manifests(d)
    cdir = os.path.dirname(manifest)
    assert cdir == default_cache_dir([d], SHARDS, TAGS)
    assert json.load(open(manifest))["chunk_boundaries"] == [0, 8, 16, 24, 32, 40, 41]
    # JAX's front door opens the port tool's cache
    warm = jcache.resolve_reader(d, J_SHARDS, index_maps=maps, id_tags=TAGS, mode="require")
    _assert_game_data_equal(ref, warm.read())
    assert cache_tool.run(["inspect", cdir]) == 0
    out = capsys.readouterr().out
    assert "num_samples    : 41" in out and "ell_levels" in out
    assert cache_tool.run(["verify", cdir]) == 0
    with open(os.path.join(cdir, "offsets.f64"), "r+b") as f:
        f.seek(9)
        f.write(b"\xff")
    assert cache_tool.run(["verify", cdir]) == 2
    assert "offsets.f64" in capsys.readouterr().out


def test_cache_tool_prune_evicts_old_keys_keeps_fresh(dataset, capsys):
    d, _, maps = dataset
    resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode="use").read()
    root = os.path.join(d, "_photon_cache")
    (fresh,) = os.listdir(root)
    old = os.path.join(root, "old-key")
    os.makedirs(old)
    with open(os.path.join(old, MANIFEST), "w") as f:
        json.dump({"created_unix": 1.0}, f)
    os.makedirs(os.path.join(root, "torn-key"))
    assert cache_tool.run(["prune", root, "--older-than-days", "1", "--dry-run"]) == 0
    assert sorted(os.listdir(root)) == sorted([fresh, "old-key", "torn-key"])
    assert "would prune 2" in capsys.readouterr().out
    assert cache_tool.run(["prune", root, "--older-than-days", "1"]) == 0
    assert os.listdir(root) == [fresh]


# --- the warm cache feeding the stream --------------------------------------------


def test_warm_stream_decodes_no_avro_and_scores_like_the_avro_stream(dataset, monkeypatch):
    """The streaming scorer over the warm replay: every chunk comes from the
    cache, no AvroDataReader decodes, and the scores equal the Avro-fed
    stream's exactly (the same engine on the same batch shapes)."""
    from photon_tpu_torch.game.model import FixedEffectModel, GameModel
    from photon_tpu_torch.game.scoring import GameScorer
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.types import TaskType

    d, _, maps = dataset
    task = TaskType.LINEAR_REGRESSION
    w = np.random.default_rng(3).normal(size=len(maps["g"]))
    model = GameModel({"fixed": FixedEffectModel(Coefficients(means=w), "g", task)}, task)
    scorer = GameScorer(model, device="cpu", dtype=torch.float64, batch_rows=8)

    def stream(mode):
        r = resolve_reader(d, SHARDS, index_maps=maps, id_tags=TAGS, mode=mode)
        seen = []
        res = scorer.stream(r.iter_chunks(chunk_rows=8),
                            on_batch=lambda c, s: seen.append(c.provenance))
        return res.scores, seen

    avro, _ = stream("off")
    cold, cold_prov = stream("use")
    reads = []
    real_read = AvroDataReader.read
    monkeypatch.setattr(AvroDataReader, "read",
                        lambda self, *a, **k: reads.append(a) or real_read(self, *a, **k))
    warm, warm_prov = stream("require")
    assert reads == []
    assert cold_prov == [None] * 6
    assert [p["source"] for p in warm_prov] == ["cache"] * 6
    np.testing.assert_array_equal(cold, avro)
    np.testing.assert_array_equal(warm, avro)


# --- per-process ingest shards -----------------------------------------------------

from test_torch_mesh import a7_ranks  # noqa: E402,F401 - the two-rank fixture
import torch_mesh_worker as worker  # noqa: E402


@pytest.mark.parametrize("value", ["", "off", "OFF", "0/1", "0/2", "1/2", "2/5", "4/5", "1/1",
                                   "2", "a/b", "-1/2", "3/2"])
def test_ingest_shard_and_file_subset_equal_jax(dataset, monkeypatch, value):
    """Every value of ``PHOTON_INGEST_SHARD`` resolves as JAX's does (or
    raises the same error), and ``list_source_files(shard=)`` keeps the
    same round-robin subset of the 5 part files; ``shard_paths`` narrows
    the input as JAX's ``resolve_reader`` does before its cache key."""
    d, _, _ = dataset
    monkeypatch.setenv("PHOTON_INGEST_SHARD", value)
    try:
        want = jcache.ingest_shard()
    except ValueError as e:
        with pytest.raises(ValueError, match="PHOTON_INGEST_SHARD") as got:
            tcache.ingest_shard()
        assert str(got.value) == str(e)
        return
    assert tcache.ingest_shard() == want
    assert tcache.list_source_files([d], shard=want) == jcache.list_source_files([d], shard=want)
    narrowed = jcache.list_source_files([d], shard=want) if want[1] > 1 else [d]
    assert tcache.shard_paths([d]) == (narrowed, want)


def test_fewer_files_than_shards_is_jax_error(dataset):
    d, _, _ = dataset
    with pytest.raises(ValueError) as want:
        jcache.list_source_files([d], shard=(5, 6))
    with pytest.raises(ValueError) as got:
        tcache.list_source_files([d], shard=(5, 6))
    assert str(got.value) == str(want.value) and "selects 0 of 5 part files" in str(got.value)


def test_shards_read_disjoint_complete_rows_cold_and_warm(dataset, monkeypatch):
    """Cold Avro reads of the two shards are disjoint and together the
    whole dataset, equal to JAX's reads of the same shards; each shard
    builds a cache of its own, and its warm replay splits the same way."""
    d, ref, _ = dataset
    reads, dirs = {}, {}
    for k in (0, 1):
        monkeypatch.setenv("PHOTON_INGEST_SHARD", f"{k}/2")
        cold = resolve_reader(d, SHARDS, id_tags=TAGS, mode="use")
        assert cold.state == "miss" and cold.paths == tcache.list_source_files([d])[k::2]
        reads[k] = cold.read()
        _assert_game_data_equal(reads[k], jcache.resolve_reader(
            d, J_SHARDS, id_tags=TAGS, mode="off").read())
        warm = resolve_reader(d, SHARDS, id_tags=TAGS, mode="require")
        assert warm.state == "hit" and warm.paths == cold.paths
        _assert_game_data_equal(reads[k], warm.read())
        dirs[k] = warm.cache_dir
        assert dirs[k] == default_cache_dir(cold.paths, SHARDS, TAGS)
    assert dirs[0] != dirs[1]
    assert reads[0].num_samples + reads[1].num_samples == ref.num_samples == 41
    uids = [u for k in (0, 1) for u in reads[k].uids if u is not None]
    assert sorted(uids) == sorted(u for u in ref.uids if u is not None)


def test_cache_tool_builds_the_shard_the_front_door_reads(dataset, monkeypatch, capsys):
    d, _, _ = dataset
    monkeypatch.setenv("PHOTON_INGEST_SHARD", "1/2")
    assert cache_tool.run(["build", "--input-data-directories", d,
                           "--feature-shard-configurations", SHARD_ARG, "--id-tags", "userId",
                           "--chunk-rows", "8"]) == 0
    assert "ingest shard 1/2: 2 part files" in capsys.readouterr().out
    warm = resolve_reader(d, SHARDS, id_tags=TAGS, mode="require")
    assert warm.state == "hit" and len(warm.paths) == 2
    assert warm.read().num_samples == 3 + 9  # parts 1 and 3


def test_live_world_resolves_ingest_shard_and_fleet_process(a7_ranks):  # noqa: F811
    """In a two-rank Gloo world with no variable set, each rank resolves
    ``(rank, 2)`` for its ingest shard and its fleet coordinates, the
    fleet plane is on, and the ranks' files are the round-robin halves."""
    got = [worker.load(a7_ranks, "ingest_live", 2, 1, r) for r in range(2)]
    files = tcache.list_source_files([os.path.join(a7_ranks, "parts")])
    for r, g in enumerate(got):
        assert g["shard"] == (r, 2) and g["process"] == (r, 2) and g["fleet_enabled"]
        assert g["files"] == files[r::2]
        assert g["obs_dir"] == os.path.join(a7_ranks, "obs", f"p{r}")
