"""Port parity: the I/O layer against the JAX package.

Avro container files written by one package are read by the other (every
Photon schema, both codecs; records compared, never bytes: the sync
marker is random); index stores built by one package open in the other
(pure-Python and native readers); ``AvroDataReader.read`` and
``iter_chunks`` give GameData and index maps exactly equal to JAX's with
either decoder (multi-bag, multi-part, top-level and metadataMap id tags,
unlabelled rows); models saved by either package load in the other with
equal coefficients (fixed effect with variances, random effects plain and
projected, MF, single GLM), the loaded bucket layout scores like JAX's
model on the host and on the device scorer, and score files agree.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data import index_map as jimap
from photon_tpu.data import native_index as jnative
from photon_tpu.game import model as jmodel
from photon_tpu.io import avro as javro
from photon_tpu.io import model_io as jio
from photon_tpu.io import schemas as jschemas
from photon_tpu.io.data_reader import AvroDataReader as JReader
from photon_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_tpu.models.coefficients import Coefficients as JCoefficients
from photon_tpu.models.glm import model_for_task as j_model_for_task
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.data import index_map as timap
from photon_tpu_torch.data import native_index as tnative
from photon_tpu_torch.game.scoring import GameScorer as TScorer
from photon_tpu_torch.io import avro as tavro
from photon_tpu_torch.io import model_io as tio
from photon_tpu_torch.io import schemas as tschemas
from photon_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_tpu_torch.io.data_reader import FeatureShardConfig as TShard

SCHEMAS = [
    "FEATURE_AVRO",
    "NAME_TERM_VALUE_AVRO",
    "TRAINING_EXAMPLE_AVRO",
    "RESPONSE_PREDICTION_AVRO",
    "BAYESIAN_LINEAR_MODEL_AVRO",
    "SCORING_RESULT_AVRO",
    "FEATURE_SUMMARIZATION_RESULT_AVRO",
    "LATENT_FACTOR_AVRO",
]


def _ntv(rng, k):
    return [
        {"name": f"f{int(j)}", "term": "t" if j % 2 else "", "value": float(rng.normal())}
        for j in rng.choice(50, size=k, replace=False)
    ]


def _schema_records(name, seed=0, n=40):
    """n records of a schema from a seed, optional fields mixed null and set."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if name in ("FEATURE_AVRO", "NAME_TERM_VALUE_AVRO"):
            rec = _ntv(rng, 1)[0]
        elif name == "TRAINING_EXAMPLE_AVRO":
            rec = {
                "uid": None if i % 5 == 0 else f"u-{i}",
                "label": float(rng.integers(0, 2)),
                "features": _ntv(rng, int(rng.integers(0, 6))),
                "metadataMap": None if i % 4 == 0 else {"userId": f"user{i % 3}"},
                "weight": None if i % 2 else float(rng.uniform(0.5, 2)),
                "offset": None if i % 3 else float(rng.normal()),
            }
        elif name == "RESPONSE_PREDICTION_AVRO":
            rec = {"response": float(rng.normal()), "features": _ntv(rng, 3),
                   "weight": float(rng.uniform()), "offset": float(rng.normal())}
        elif name == "BAYESIAN_LINEAR_MODEL_AVRO":
            rec = {"modelId": f"m{i}", "modelClass": None if i % 2 else "cls",
                   "means": _ntv(rng, 4), "variances": None if i % 3 else _ntv(rng, 2),
                   "lossFunction": None}
        elif name == "SCORING_RESULT_AVRO":
            rec = {"uid": f"s{i}", "label": None if i % 3 == 0 else 1.0, "modelId": "m",
                   "predictionScore": float(rng.normal()), "weight": None,
                   "metadataMap": None if i % 2 else {"k": "vé"}}
        elif name == "FEATURE_SUMMARIZATION_RESULT_AVRO":
            rec = {"featureName": f"f{i}", "featureTerm": "",
                   "metrics": {"mean": float(rng.normal()), "max": float(rng.normal())}}
        else:
            rec = {"effectId": f"e{i}", "latentFactor": [float(x) for x in rng.normal(size=4)]}
        out.append(rec)
    return out


@pytest.mark.parametrize("name", SCHEMAS)
def test_schema_dicts_equal(name):
    assert getattr(tschemas, name) == getattr(jschemas, name)


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("name", SCHEMAS)
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_avro_round_trip_across_packages(tmp_path, direction, name, codec):
    write, read = (
        (tavro.write_avro_file, javro.read_avro_file)
        if direction == "port_to_jax"
        else (javro.write_avro_file, tavro.read_avro_file)
    )
    records = _schema_records(name)
    path = tmp_path / "part-00000.avro"
    # a small sync interval: several blocks per file
    assert write(path, getattr(tschemas, name), records, codec=codec, sync_interval=7) == 40
    assert read(path) == records
    assert tavro.read_schema(path) == javro.read_schema(path)
    assert tavro.avro_part_files(tmp_path) == javro.avro_part_files(tmp_path)


def test_incremental_writer_reads_as_one_file(tmp_path):
    records = _schema_records("TRAINING_EXAMPLE_AVRO", seed=3)
    with tavro.AvroFileWriter(tmp_path / "a.avro", tschemas.TRAINING_EXAMPLE_AVRO,
                              sync_interval=5) as w:
        w.append(records[:13])
        w.append(records[13:])
    assert w.total == len(records)
    assert list(javro.read_avro_dir(tmp_path)) == records


# ---------------------------------------------------------------------------
# index stores
# ---------------------------------------------------------------------------

KEYS = [timap.feature_key(f"f{i}", "t" if i % 3 else "") for i in range(300)] + [
    timap.INTERCEPT_KEY, timap.feature_key("x" * 400, "long")
]


@pytest.mark.parametrize("native", [False, True], ids=["pymmap", "native"])
@pytest.mark.parametrize("builder", ["jax", "port"])
def test_partitioned_store_across_packages(tmp_path, builder, native):
    build = jnative.build_partitioned_store if builder == "jax" else tnative.build_partitioned_store
    build(tmp_path, {"global": KEYS, "user": KEYS[:7]}, num_partitions=3)
    for shard, keys in (("global", KEYS), ("user", KEYS[:7])):
        jm = jnative.load_partitioned_store(tmp_path, shard, prefer_native=False)
        tm = tnative.load_partitioned_store(tmp_path, shard, prefer_native=native)
        assert len(tm) == len(jm) == len(keys)
        for k in keys + ["missing\x01key"]:
            assert tm.get_index(k) == jm.get_index(k)
        for i in range(-1, len(keys) + 1):
            assert tm.get_feature_name(i) == jm.get_feature_name(i)
        assert tm.has_intercept == jm.has_intercept


def test_store_reader_kinds():
    assert isinstance(timap.DefaultIndexMap.from_keys(["a"]), timap.IndexMap)
    assert timap.INTERSECT == jimap.INTERSECT == "\x01"
    assert tnative.load_native_lib() is not None, tnative.native_unavailable_reason


# ---------------------------------------------------------------------------
# AvroDataReader
# ---------------------------------------------------------------------------

#: TrainingExampleAvro with a second feature bag, a top-level string
#: column and a nullable label
GAME_SCHEMA = {
    "name": "GameExample",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "features", "type": {"type": "array", "items": tschemas.FEATURE_AVRO}},
        # a record of its own name (a reference to FeatureAvro by name
        # would send the native decoder to the Python path)
        {"name": "userFeatures",
         "type": {"type": "array", "items": dict(tschemas.FEATURE_AVRO, name="UserFeatureAvro")}},
        {"name": "itemId", "type": "string"},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}
GAME_SHARDS = {
    "global": (("features", "userFeatures"), True),
    "user": (("userFeatures",), False),
}
GAME_TAGS = ("itemId", "userId")


def _game_records(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "uid": None if i % 9 == 0 else f"r{seed}-{i}",
            "label": None if i % 7 == 3 else float(rng.integers(0, 2)),
            "features": _ntv(rng, int(rng.integers(0, 5))),
            "userFeatures": [{"name": f"uf{int(j)}", "term": "", "value": float(rng.normal())}
                             for j in rng.choice(6, size=int(rng.integers(1, 3)), replace=False)],
            "itemId": f"item{int(rng.integers(4))}",
            "metadataMap": {"userId": f"user{int(rng.integers(5))}", "itemId": "shadowed"},
            "weight": None if i % 2 else float(rng.uniform(0.5, 2.0)),
            "offset": float(rng.normal(scale=0.1)),
        })
    return out


@pytest.fixture(scope="module")
def game_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("game-avro")
    for part, n in enumerate((23, 1, 40)):  # uneven part files
        javro.write_avro_file(d / f"part-{part:05d}.avro", GAME_SCHEMA,
                              _game_records(part, n), sync_interval=10)
    return d


def _shards(cls):
    return {s: cls(feature_bags=b, has_intercept=i) for s, (b, i) in GAME_SHARDS.items()}


def _assert_game_data_equal(t, j, id_tags=GAME_TAGS):
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.weights, j.weights)
    assert list(t.uids) == list(j.uids)
    assert set(t.feature_shards) == set(j.feature_shards)
    for s, tm in t.feature_shards.items():
        jm = j.feature_shards[s]
        for field in ("indptr", "indices", "values"):
            a, b = getattr(tm, field), getattr(jm, field)
            assert a.dtype == b.dtype, (s, field)
            np.testing.assert_array_equal(a, b)
        assert tm.num_cols == jm.num_cols
    for tag in id_tags:
        np.testing.assert_array_equal(t.id_tags[tag], j.id_tags[tag])


def _assert_maps_equal(tmaps, jmaps):
    assert set(tmaps) == set(jmaps)
    for s in tmaps:
        assert dict(iter(tmaps[s])) == dict(iter(jmaps[s]))


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_reader_read_equals_jax(game_dir, monkeypatch, decoder):
    if decoder == "python":
        monkeypatch.setenv("PHOTON_NO_NATIVE_AVRO", "1")
    tr, jr = TReader(), JReader()
    t = tr.read(str(game_dir), _shards(TShard), id_tags=GAME_TAGS)
    j = jr.read(str(game_dir), _shards(JShard), id_tags=GAME_TAGS)
    assert tr.last_decoder == decoder
    assert (tr.last_decoder_reason is None) == (decoder == "native")
    assert np.isnan(t.labels).sum() == 9  # unlabelled rows read as NaN
    # the top-level column wins over the metadataMap entry of the same name
    assert not (np.asarray(t.id_tags["itemId"]) == "shadowed").any()
    _assert_game_data_equal(t, j)
    _assert_maps_equal(tr.index_maps, jr.index_maps)


@pytest.mark.parametrize("chunk_rows", [1, 7, 24, 64, 100])
@pytest.mark.parametrize("decoder", ["native", "python"])
def test_reader_iter_chunks_equals_jax(game_dir, monkeypatch, decoder, chunk_rows):
    if decoder == "python":
        monkeypatch.setenv("PHOTON_NO_NATIVE_AVRO", "1")
    jr = JReader()
    jr.read(str(game_dir), _shards(JShard))
    maps = jr.index_maps
    tmaps = {s: timap.DefaultIndexMap(dict(iter(m))) for s, m in maps.items()}
    t_chunks = list(TReader(tmaps).iter_chunks(
        str(game_dir), _shards(TShard), id_tags=GAME_TAGS, chunk_rows=chunk_rows))
    j_chunks = list(JReader(maps).iter_chunks(
        str(game_dir), _shards(JShard), id_tags=GAME_TAGS, chunk_rows=chunk_rows))
    assert [c.num_samples for c in t_chunks] == [c.num_samples for c in j_chunks]
    assert sum(c.num_samples for c in t_chunks) == 64
    for t, j in zip(t_chunks, j_chunks):
        _assert_game_data_equal(t, j)


def test_reader_with_prebuilt_store_and_missing_tag(game_dir, tmp_path):
    keys = ["f1\x01t", "f2\x01", "uf3\x01", timap.INTERCEPT_KEY]
    tnative.build_partitioned_store(tmp_path, {"global": keys}, num_partitions=2)
    shards = {"global": TShard(feature_bags=("features", "userFeatures"))}
    jshards = {"global": JShard(feature_bags=("features", "userFeatures"))}
    t = TReader({"global": tnative.load_partitioned_store(tmp_path, "global")}).read(
        str(game_dir), shards)
    j = JReader({"global": jnative.load_partitioned_store(tmp_path, "global")}).read(
        str(game_dir), jshards)
    _assert_game_data_equal(t, j, id_tags=())
    with pytest.raises(ValueError, match="missing id tag"):
        os.environ["PHOTON_NO_NATIVE_AVRO"] = "1"
        try:
            TReader().read(str(game_dir), shards, id_tags=("queryId",))
        finally:
            del os.environ["PHOTON_NO_NATIVE_AVRO"]
    with pytest.raises(ValueError, match="index maps for every shard"):
        next(TReader().iter_chunks(str(game_dir), shards))


# ---------------------------------------------------------------------------
# model persistence
# ---------------------------------------------------------------------------

FE_KEYS = [timap.feature_key(f"f{i}", "t" if i % 2 else "") for i in range(12)]
RE_KEYS = [timap.feature_key(f"u{i}") for i in range(5)]


def _index_maps(mod):
    return {
        "global": mod.DefaultIndexMap.from_keys(FE_KEYS),
        "user": mod.DefaultIndexMap.from_keys(RE_KEYS, add_intercept=False),
    }


def _jax_model(seed=0):
    """A JAX GameModel with every coordinate kind; |coefficients| > 1e-3
    so the default sparsity threshold keeps them all, except planted zeros."""
    rng = np.random.default_rng(seed)

    def coef(*shape):
        return np.sign(rng.normal(size=shape)) * rng.uniform(0.01, 1.0, size=shape)

    d_fe = len(FE_KEYS) + 1
    means = coef(d_fe)
    means[3] = 0.0
    fe = jmodel.FixedEffectModel(
        model=j_model_for_task(JTask.LOGISTIC_REGRESSION, JCoefficients(
            means=jnp.asarray(means), variances=jnp.asarray(rng.uniform(0.1, 1, d_fe)))),
        feature_shard="global",
    )
    vocab = np.array([f"user{i}" for i in range(6)])
    # index-mapped: buckets of width 2 and 4 with -1 padding; entity 5 unmodeled
    b0 = jmodel.BucketCoefficients(
        entity_ids=np.array([0, 2, 4], dtype=np.int32),
        col_index=np.array([[0, 3], [1, -1], [4, 2]], dtype=np.int32),
        coefficients=coef(3, 2) * np.array([[1, 1], [1, 0], [1, 1]]),
        variances=rng.uniform(0.1, 1, (3, 2)),
    )
    b1 = jmodel.BucketCoefficients(
        entity_ids=np.array([1, 3], dtype=np.int32),
        col_index=np.array([[0, 1, 2, 4], [3, 4, -1, -1]], dtype=np.int32),
        coefficients=coef(2, 4) * np.array([[1, 1, 1, 1], [1, 1, 0, 0]]),
        variances=rng.uniform(0.1, 1, (2, 4)),
    )
    re = jmodel.RandomEffectModel(
        random_effect_type="userId", feature_shard="user", task=JTask.LOGISTIC_REGRESSION,
        vocab=vocab, buckets=(b0, b1), num_features=len(RE_KEYS),
    )
    proj = rng.normal(size=(d_fe, 3))
    rp = jmodel.RandomEffectModel(
        random_effect_type="itemId", feature_shard="global", task=JTask.LOGISTIC_REGRESSION,
        vocab=np.array(["a", "b", "c"]),
        buckets=(jmodel.BucketCoefficients(
            entity_ids=np.array([0, 1, 2], dtype=np.int32),
            col_index=np.tile(np.arange(3, dtype=np.int32), (3, 1)),
            coefficients=coef(3, 3)),),
        num_features=d_fe, projection_matrix=proj,
    )
    mf = jmodel.MatrixFactorizationModel(
        row_entity_type="userId", col_entity_type="itemId",
        row_vocab=np.array(["user0", "user1", "user3"]), col_vocab=np.array(["a", "c"]),
        row_factors=coef(3, 2), col_factors=coef(2, 2),
    )
    return jmodel.GameModel(
        coordinates={"global": fe, "per-user": re, "per-item": rp, "mf": mf},
        task=JTask.LOGISTIC_REGRESSION,
    )


def _assert_jax_models_equal(a, b):
    assert a.task == b.task and set(a.coordinates) == set(b.coordinates)
    for cid, ca in a.coordinates.items():
        cb = b.coordinates[cid]
        if isinstance(ca, jmodel.FixedEffectModel):
            for f in ("means", "variances"):
                np.testing.assert_array_equal(getattr(ca.model.coefficients, f),
                                              getattr(cb.model.coefficients, f))
        elif isinstance(ca, jmodel.RandomEffectModel):
            np.testing.assert_array_equal(ca.vocab, cb.vocab)
            assert len(ca.buckets) == len(cb.buckets)
            for ba, bb in zip(ca.buckets, cb.buckets):
                for f in ("entity_ids", "col_index", "coefficients", "variances"):
                    x, y = getattr(ba, f), getattr(bb, f)
                    assert (x is None) == (y is None)
                    if x is not None:
                        np.testing.assert_array_equal(x, y)
            if ca.projection_matrix is not None:
                np.testing.assert_array_equal(ca.projection_matrix, cb.projection_matrix)
        else:
            for f in ("row_vocab", "col_vocab", "row_factors", "col_factors"):
                np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    """JAX model → JAX save (a) → port load → port save (b) → JAX load."""
    root = tmp_path_factory.mktemp("models")
    jm = _jax_model()
    jio.save_game_model(root / "a", jm, _index_maps(jimap),
                        optimization_configurations={"global": 1.0})
    tm = tio.load_game_model(root / "a", _index_maps(timap))
    tio.save_game_model(root / "b", tm, _index_maps(timap),
                        optimization_configurations={"global": 1.0})
    return root, jm, tm


def test_game_model_round_trip_jax_port_jax(saved_models):
    root, _, _ = saved_models
    first = jio.load_game_model(root / "a", _index_maps(jimap))
    again = jio.load_game_model(root / "b", _index_maps(jimap))
    _assert_jax_models_equal(first, again)
    assert (root / "a" / "model-metadata.json").read_text() == (
        root / "b" / "model-metadata.json").read_text()


def test_loaded_model_equals_jax_loaded(saved_models):
    root, jm, tm = saved_models
    jl = jio.load_game_model(root / "a", _index_maps(jimap))
    assert list(tm.coordinates) == list(jl.coordinates)
    fe = tm.coordinates["global"].coefficients
    np.testing.assert_array_equal(fe.means, np.asarray(jm.coordinates["global"].model.coefficients.means))
    np.testing.assert_array_equal(fe.variances,
                                  np.asarray(jm.coordinates["global"].model.coefficients.variances))
    for cid in ("per-user", "per-item"):
        t, j = tm.coordinates[cid], jl.coordinates[cid]
        np.testing.assert_array_equal(t.vocab, j.vocab)
        for bt, bj in zip(t.buckets, j.buckets):
            np.testing.assert_array_equal(bt.entity_ids, bj.entity_ids)
            np.testing.assert_array_equal(bt.col_index, bj.col_index)
            np.testing.assert_array_equal(bt.coefficients, bj.coefficients)
    mf_t, mf_j = tm.coordinates["mf"], jm.coordinates["mf"]
    np.testing.assert_array_equal(mf_t.row_factors, mf_j.row_factors)
    np.testing.assert_array_equal(mf_t.col_vocab, mf_j.col_vocab)


def _score_data(seed=5, n=300):
    """The same rows for both packages' GameData."""
    from photon_tpu.game.data import CSRMatrix as JCSR
    from photon_tpu.game.data import GameData as JData
    from photon_tpu_torch.game.data import CSRMatrix as TCSR
    from photon_tpu_torch.game.data import GameData as TData

    rng = np.random.default_rng(seed)
    d_fe, d_re = len(FE_KEYS) + 1, len(RE_KEYS)
    x = rng.normal(size=(n, d_fe)) * (rng.uniform(size=(n, d_fe)) < 0.5)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, d_re)) * (rng.uniform(size=(n, d_re)) < 0.6)
    tags = {"userId": np.array([f"user{i}" for i in rng.integers(0, 8, n)]),
            "itemId": np.array([f"{c}" for c in rng.choice(list("abcd"), n)])}
    offsets = rng.normal(size=n) * 0.1
    out = []
    for CSR, Data in ((JCSR, JData), (TCSR, TData)):
        out.append(Data.build(
            labels=np.zeros(n),
            feature_shards={"global": CSR.from_dense(x), "user": CSR.from_dense(xu)},
            offsets=offsets, id_tags=tags,
        ))
    return out


def test_loaded_regrouped_model_scores_like_jax(saved_models):
    from photon_tpu.game.transformer import GameTransformer as JTransformer
    from photon_tpu_torch.game.transformer import GameTransformer as TTransformer

    root, jm, tm = saved_models
    jdata_, tdata_ = _score_data()
    want = JTransformer(model=jm, task=jm.task).score(jdata_)
    host = TTransformer(model=tm, task=tm.task, device="cpu").score(tdata_)
    np.testing.assert_allclose(host, want, rtol=1e-12, atol=1e-12)
    device = TScorer(tm, device="cpu", batch_rows=64).score_data(tdata_)
    np.testing.assert_allclose(device, want, rtol=1e-5, atol=1e-5)
    dev64 = TScorer(tm, device="cpu", dtype=torch.float64, batch_rows=64).score_data(tdata_)
    np.testing.assert_allclose(dev64, want, rtol=1e-12, atol=1e-12)


def test_read_model_feature_keys_equal(saved_models, tmp_path):
    root, jm, _ = saved_models
    # without the projected coordinate (its names are positional)
    coords = {k: v for k, v in jm.coordinates.items() if k != "per-item"}
    plain = jmodel.GameModel(coordinates=coords, task=jm.task)
    jio.save_game_model(tmp_path, plain, _index_maps(jimap))
    cfg_t = {"global": TShard(("features",)), "user": TShard(("u",), has_intercept=False)}
    cfg_j = {"global": JShard(("features",)), "user": JShard(("u",), has_intercept=False)}
    _assert_maps_equal(tio.read_model_feature_keys(tmp_path, cfg_t),
                       jio.read_model_feature_keys(tmp_path, cfg_j))
    with pytest.raises(ValueError, match="random projection"):
        tio.read_model_feature_keys(root / "a", cfg_t)


def test_glm_round_trip_jax_port_jax(tmp_path):
    imap_j, imap_t = (m.DefaultIndexMap.from_keys(FE_KEYS) for m in (jimap, timap))
    rng = np.random.default_rng(2)
    means = rng.normal(size=len(imap_j))
    means[[2, 5]] = [0.0, 5e-5]  # dropped by the sparsity threshold
    glm = j_model_for_task(JTask.POISSON_REGRESSION, JCoefficients(
        means=jnp.asarray(means), variances=jnp.asarray(rng.uniform(size=len(imap_j)))))
    jio.save_glm(tmp_path / "a.avro", glm, JTask.POISSON_REGRESSION, imap_j, model_id="m")
    tglm, task = tio.load_glm(tmp_path / "a.avro", imap_t)
    assert task.name == "POISSON_REGRESSION" and tglm.task.name == "POISSON_REGRESSION"
    tio.save_glm(tmp_path / "b.avro", tglm, task, imap_t, model_id="m")
    assert javro.read_avro_file(tmp_path / "a.avro") == tavro.read_avro_file(tmp_path / "b.avro")
    back, _ = jio.load_glm(tmp_path / "b.avro", imap_j)
    want = means.copy()
    want[5] = 0.0
    np.testing.assert_array_equal(np.asarray(back.coefficients.means), want)
    np.testing.assert_array_equal(tglm.coefficients.variances.numpy(),
                                  np.asarray(glm.coefficients.variances))


@pytest.mark.parametrize("encoder", ["native", "python"])
def test_scoring_results_equal_jax(tmp_path, monkeypatch, encoder):
    if encoder == "python":
        monkeypatch.setenv("PHOTON_NO_NATIVE_AVRO", "1")
    rng = np.random.default_rng(4)
    n = 37
    cols = dict(scores=rng.normal(size=n), labels=rng.integers(0, 2, n).astype(float),
                weights=rng.uniform(size=n), uids=[None if i % 5 == 0 else f"s{i}"
                                                   for i in range(n)])
    tio.save_scoring_results(tmp_path / "t.avro", cols["scores"], model_id="m",
                             labels=cols["labels"], weights=cols["weights"], uids=cols["uids"])
    jio.save_scoring_results(tmp_path / "j.avro", cols["scores"], model_id="m",
                             labels=cols["labels"], weights=cols["weights"], uids=cols["uids"])
    assert javro.read_avro_file(tmp_path / "t.avro") == javro.read_avro_file(tmp_path / "j.avro")

    tw = tio.ShardedScoringWriter(tmp_path / "ts", num_partitions=3, model_id="m")
    jw = jio.ShardedScoringWriter(tmp_path / "js", num_partitions=3, model_id="m")
    for lo, hi in ((0, 10), (10, 11), (11, 30), (30, 37)):
        for w in (tw, jw):
            w.write_chunk(cols["scores"][lo:hi], labels=cols["labels"][lo:hi],
                          weights=cols["weights"][lo:hi], uids=cols["uids"][lo:hi])
    assert tw.close() == jw.close() == n
    assert tw.encoders == {encoder}
    assert [os.path.basename(p) for p in tw.paths()] == [os.path.basename(p) for p in jw.paths()]
    for tp, jp in zip(tw.paths(), jw.paths()):
        assert tavro.read_avro_file(tp) == javro.read_avro_file(jp)
    with pytest.raises(ValueError, match="closed"):
        tw.write_chunk(cols["scores"])
