"""Port parity against files written by the reference JVM stack.

The fixtures under tests/fixtures/jvm/ were written by the Scala/Spark
reference (heart.avro from its driver integration test, the
mixed-effects GAME model from its GAME integration test);
tests/test_jvm_parity.py holds the JAX package to them. These are the
same checks on the port: its Avro reads, its model-tree load, its scores
against expected_scores.json (through the host scorer, and through
``GameScorer`` at float64 on the CPU) and its training to the unique
optimum of a strictly convex problem.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "jvm")
MODEL_DIR = os.path.join(FIXTURES, "mixedEffectsModel")
SHARDS = {"shard1": None, "shard2": None, "shard3": None}


def _heart_shard_config():
    from photon_tpu_torch.io.data_reader import FeatureShardConfig

    return {"global": FeatureShardConfig(feature_bags=("features",), has_intercept=True)}


@pytest.fixture(scope="module")
def jvm_model():
    from photon_tpu_torch.io.model_io import load_game_model, read_model_feature_keys

    index_maps = read_model_feature_keys(MODEL_DIR, SHARDS)
    return load_game_model(MODEL_DIR, index_maps), index_maps


def test_reads_jvm_training_example_file():
    """heart.avro: 250 TrainingExampleAvro records written by the JVM."""
    from photon_tpu_torch.io.avro import read_avro_file

    records = read_avro_file(os.path.join(FIXTURES, "heart.avro"))
    assert len(records) == 250
    r = records[0]
    assert set(r) >= {"features", "label", "offset", "uid", "weight"}
    assert r["features"][0] == {"name": "1", "term": "", "value": 70.0}
    assert {rec["label"] for rec in records} == {0.0, 1.0}


def test_jvm_training_file_through_data_reader():
    """The same file through AvroDataReader → DataSet; the file is outside
    the native decoder's subset, and the reader says so."""
    from photon_tpu_torch.io.data_reader import AvroDataReader

    reader = AvroDataReader()
    game = reader.read(os.path.join(FIXTURES, "heart.avro"), _heart_shard_config())
    assert reader.last_decoder in ("native", "python")
    if reader.last_decoder == "python":
        assert reader.last_decoder_reason
    ds = game.shard_dataset("global")
    assert ds.num_samples == 250
    assert ds.num_features == 14  # 13 heart features + intercept
    dense = ds.to_dense()
    assert np.all(dense[:, -1] == 1.0)
    i70 = reader.index_maps["global"].get_index("1\x01")
    assert dense[0, i70] == 70.0


def test_loads_jvm_game_model_tree(jvm_model):
    """The mixed-effects model (fixed effect 'global', per-song and
    per-artist random effects; per-user is id info only) loads with the
    values of its Avro records, and scores unseen entities as zero."""
    from photon_tpu_torch.game.data import CSRMatrix, GameData
    from photon_tpu_torch.io.avro import read_avro_dir, read_avro_file

    model, index_maps = jvm_model
    assert set(model.coordinates) == {"global", "per-song", "per-artist"}
    assert model.task.value == "LINEAR_REGRESSION"
    [fe_rec] = read_avro_file(
        os.path.join(MODEL_DIR, "fixed-effect", "global", "coefficients", "part-00000.avro")
    )
    fe = model.coordinates["global"]
    assert fe.feature_shard == "shard1"
    w = np.asarray(fe.coefficients.means)
    for ntv in fe_rec["means"][:50]:
        idx = index_maps["shard1"].get_index(f"{ntv['name']}\x01{ntv['term']}")
        assert idx >= 0
        assert w[idx] == pytest.approx(ntv["value"], rel=1e-12)

    re = model.coordinates["per-song"]
    assert re.random_effect_type == "songId"
    recs = list(read_avro_dir(os.path.join(MODEL_DIR, "random-effect", "per-song", "coefficients")))
    assert len(re.modeled_keys()) == len({r["modelId"] for r in recs})
    probe = recs[0]
    glm = re.entity_model(str(probe["modelId"]))
    assert glm is not None
    w = np.asarray(glm.coefficients.means)
    for ntv in probe["means"]:
        idx = index_maps["shard3"].get_index(f"{ntv['name']}\x01{ntv['term']}")
        assert w[idx] == pytest.approx(ntv["value"], rel=1e-12)

    song_ids = sorted(re.modeled_keys())[:4] + ["unseen-song"]
    x = np.random.default_rng(0).normal(size=(len(song_ids), len(index_maps["shard3"])))
    data = GameData.build(
        labels=np.zeros(len(song_ids)),
        feature_shards={"shard3": CSRMatrix.from_dense(x)},
        id_tags={"songId": song_ids},
    )
    scores = re.score_cold(data)
    assert scores.shape == (len(song_ids),) and np.all(np.isfinite(scores))
    assert np.any(scores[:-1] != 0) and scores[-1] == 0.0


def _expected_score_data(index_maps):
    from photon_tpu_torch.game.data import CSRMatrix, GameData

    with open(os.path.join(FIXTURES, "expected_scores.json")) as f:
        fix = json.load(f)

    def shard_csr(shard_name):
        imap = index_maps[shard_name]
        indptr, indices, values = [0], [], []
        for s in fix["samples"]:
            for key, v in s[shard_name]:
                idx = imap.get_index(key)
                assert idx >= 0, (shard_name, key)
                indices.append(idx)
                values.append(v)
            indptr.append(len(indices))
        return CSRMatrix(
            indptr=np.asarray(indptr, np.int64),
            indices=np.asarray(indices, np.int32),
            values=np.asarray(values, np.float64),
            num_cols=len(imap),
        )

    n = len(fix["samples"])
    data = GameData.build(
        labels=np.zeros(n),
        feature_shards={"shard1": shard_csr("shard1"), "shard3": shard_csr("shard3")},
        id_tags={
            "songId": [s["songId"] for s in fix["samples"]],
            "artistId": [s["artistId"] for s in fix["samples"]],
        },
    )
    return data, np.asarray(fix["expected_scores"])


def test_jvm_model_score_parity_host_scorer(jvm_model):
    """Loader → index maps → host scorer reproduce expected_scores.json,
    which was computed from the raw Avro records with plain dict algebra."""
    model, index_maps = jvm_model
    data, expected = _expected_score_data(index_maps)
    np.testing.assert_allclose(model.score(data), expected, rtol=1e-10, atol=1e-12)


def test_jvm_model_score_parity_game_scorer(jvm_model):
    """The same scores through the batch scorer at float64 on the CPU."""
    from photon_tpu_torch.game.scoring import GameScorer

    model, index_maps = jvm_model
    data, expected = _expected_score_data(index_maps)
    scores = GameScorer(model, device="cpu", dtype=torch.float64).score_data(data)
    np.testing.assert_allclose(scores, expected, rtol=1e-10, atol=1e-12)


def test_train_on_jvm_fixture_reaches_unique_optimum():
    """L2 logistic regression is strictly convex, so any correct optimizer
    reaches the SAME coefficients: the port's L-BFGS on the JVM-written
    heart.avro (columns scaled to unit std) matches an independent scipy
    L-BFGS-B solve, and its validation AUC on heart_validation.avro sits
    in the known-good band."""
    from scipy.optimize import minimize

    from photon_tpu_torch.evaluation.evaluators import area_under_roc_curve
    from photon_tpu_torch.io.data_reader import AvroDataReader
    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_tpu_torch.types import LabeledBatch, TaskType

    reader = AvroDataReader()
    ds = reader.read(os.path.join(FIXTURES, "heart.avro"), _heart_shard_config()).shard_dataset(
        "global"
    )
    lam = 1.0
    x = ds.to_dense().astype(np.float64)
    y = np.asarray(ds.labels, np.float64)
    scale = np.maximum(x.std(axis=0), 1e-12)
    scale[x.std(axis=0) == 0] = 1.0  # intercept column untouched
    x = x / scale
    n = x.shape[0]
    batch = LabeledBatch(
        features=torch.as_tensor(x), labels=torch.as_tensor(y),
        offsets=torch.zeros(n, dtype=torch.float64), weights=torch.ones(n, dtype=torch.float64),
    )
    models = train_glm_grid(
        batch,
        GLMProblemConfig(
            task=TaskType.LOGISTIC_REGRESSION,
            regularization=RegularizationContext(regularization_type=RegularizationType.L2),
            optimizer_config=OptimizerConfig(max_iterations=500, tolerance=1e-12),
        ),
        [lam],
        dtype=torch.float64,
        device="cpu",
    )
    w_ours = models[0].model.coefficients.means.numpy()

    def objective(w):
        z = x @ w
        s = np.where(y > 0.5, z, -z)
        val = np.sum(np.logaddexp(0.0, -s)) + 0.5 * lam * w @ w
        p = 1.0 / (1.0 + np.exp(-z))
        return val, x.T @ (p - (y > 0.5)) + lam * w

    ref = minimize(objective, np.zeros(x.shape[1]), jac=True, method="L-BFGS-B",
                   options={"maxiter": 500, "ftol": 1e-14, "gtol": 1e-10})
    np.testing.assert_allclose(w_ours, ref.x, rtol=2e-4, atol=2e-5)

    vds = reader.read(
        os.path.join(FIXTURES, "heart_validation.avro"), _heart_shard_config()
    ).shard_dataset("global")
    scores = (vds.to_dense().astype(np.float64) / scale) @ w_ours
    auc = float(area_under_roc_curve(torch.as_tensor(scores),
                                     torch.as_tensor(np.asarray(vds.labels, np.float64))))
    assert 0.70 <= auc <= 0.90, auc
