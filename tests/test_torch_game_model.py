"""Port parity of the GAME model classes, GameTransformer and GameScorer.

A JAX model with a fixed effect, a randomly projected per-user random
effect, an index-mapped per-item random effect and a user × item MF
coordinate is carried into the port (``game_model_from_numpy``) and
scored on data with unseen users and items: ``GameModel.score`` /
``score_cold`` and the transformer against JAX's host path at 1e-9, and
the port's float64 device scorer against JAX's host path at 1e-9 and
against JAX's (float32) scorer at 1e-5, for the projected, index-mapped
and MF layouts alone and together. Also the layouts the scorer refuses.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.evaluation.evaluators import EvaluatorType as JEval
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.game.model import GameModel as JGameModel
from photon_tpu.game.scoring import GameScorer as JScorer
from photon_tpu.game.transformer import GameTransformer as JTransformer
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.evaluation.evaluators import EvaluatorType as TEval
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game import scoring as tscoring
from photon_tpu_torch.game.model import (
    GameModel,
    MatrixFactorizationModel,
    merge_random_effect_carryover,
)
from photon_tpu_torch.game.scoring import GameScorer, UnsupportedModelLayout
from photon_tpu_torch.game.transformer import GameTransformer
from photon_tpu_torch.types import TaskType as TTask
from test_torch_game import _numpy_model, small_arrays, small_configs, small_data

COORDS = ("fixed", "user", "item", "mf")


@pytest.fixture(scope="module")
def models():
    arrays = small_arrays(seed=12)
    replace = {"user": {"projector_type": lambda m: m.ProjectorType.RANDOM,
                        "random_projection_dim": 5}}
    jtrain = small_data(jdata, arrays)
    jmodel = JEstimator(
        task=JTask.LOGISTIC_REGRESSION,
        coordinate_configs=small_configs("jax", COORDS, replace=replace),
        update_sequence=list(COORDS), descent_iterations=2, dtype=jnp.float64,
    ).fit(jtrain)[0].model
    tmodel = _numpy_model(jmodel)
    score_arrays = small_arrays(seed=13, n=700, users=32, items=10)  # unseen entities
    return jmodel, tmodel, small_data(jdata, score_arrays), small_data(tdata, score_arrays)


def _subset(model, cids):
    cls = JGameModel if isinstance(model, JGameModel) else GameModel
    return cls(coordinates={c: model.coordinates[c] for c in cids}, task=model.task)


def test_model_scores_match_jax(models):
    jmodel, tmodel, jd, td = models
    assert tmodel["user"].projection_matrix is not None
    for cid in ("user", "item", "mf"):
        np.testing.assert_allclose(
            tmodel[cid].score_cold(td), jmodel[cid].score_cold(jd), rtol=1e-9, atol=1e-12
        )
    assert np.all(tmodel["mf"].score_cold(td)[td.id_tags["user"] == "u31"] == 0.0)
    np.testing.assert_allclose(tmodel.score(td), jmodel.score(jd), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tmodel.predict(td), jmodel.predict(jd), rtol=1e-9, atol=1e-12)
    assert tmodel.required_id_tags() == jmodel.required_id_tags() == {"user", "item"}


def test_random_effect_model_views_match_jax(models):
    jmodel, tmodel, _, _ = models
    for cid in ("user", "item"):
        jm, tm = jmodel[cid], tmodel[cid]
        assert tm.modeled_keys() == jm.modeled_keys()
        for a, b in zip(tm.dense_coefficient_lookup(), jm.dense_coefficient_lookup()):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
        key = sorted(tm.modeled_keys())[0]
        np.testing.assert_array_equal(
            tm.entity_model(key).coefficients.means.numpy(),
            np.asarray(jm.entity_model(key).coefficients.means),
        )
        assert tm.entity_model("nobody") is None


def test_bucket_scoring_equals_cold_scoring():
    """On its own training data, the model scored through the dataset's
    flat arrays equals the cold lookup (index-mapped random effect)."""
    arrays = small_arrays(seed=14)
    td = small_data(tdata, arrays)
    from photon_tpu_torch.game.estimator import GameEstimator

    est = GameEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=small_configs("torch"),
        update_sequence=["fixed", "user"], descent_iterations=1, dtype=torch.float64,
        device="cpu",
    )
    model = est.fit(td)[0].model
    ds = tdata.build_random_effect_dataset(td, small_configs("torch")["user"])
    np.testing.assert_allclose(
        model["user"].score(td, ds), model["user"].score_cold(td), rtol=1e-6, atol=1e-6
    )


def test_transformer_matches_jax(models):
    jmodel, tmodel, jd, td = models
    tt = GameTransformer(tmodel, TTask.LOGISTIC_REGRESSION, device="cpu")
    jt = JTransformer(jmodel, JTask.LOGISTIC_REGRESSION)
    np.testing.assert_allclose(tt.score(td), jt.score(jd), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tt.predict(td), jt.predict(jd), rtol=1e-9, atol=1e-12)
    for te, je in ((TEval.AUC, JEval.AUC), (TEval.LOGISTIC_LOSS, JEval.LOGISTIC_LOSS)):
        np.testing.assert_allclose(tt.evaluate(td, te), jt.evaluate(jd, je), rtol=1e-9)
    assert isinstance(tt.streaming_scorer(dtype=torch.float64), GameScorer)


@pytest.mark.parametrize(
    "cids",
    [("fixed", "user"), ("fixed", "item"), ("mf",), COORDS],
    ids=["projected", "index-mapped", "mf", "all"],
)
def test_scorer_matches_jax(models, cids):
    jmodel, tmodel, jd, td = _subset(models[0], cids), _subset(models[1], cids), *models[2:]
    got = GameScorer(tmodel, device="cpu", dtype=torch.float64, batch_rows=128).score_data(td)
    assert got.shape == (td.num_samples,)
    np.testing.assert_allclose(got, jmodel.score(jd) + jd.offsets, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        got, np.asarray(JScorer(jmodel, batch_rows=128).score_data(jd)), rtol=1e-5, atol=1e-5
    )


def test_scorer_refusals(models, monkeypatch):
    _, tmodel, _, _ = models
    wide = tscoring.DENSE_COLS_MAX + 1
    with pytest.raises(UnsupportedModelLayout, match="dense gather limit"):
        GameScorer(
            GameModel({"item": dataclasses.replace(tmodel["item"], num_features=wide)},
                      tmodel.task),
            device="cpu",
        )
    # a projected random effect is not bound by the dense limit
    GameScorer(
        GameModel({"user": dataclasses.replace(tmodel["user"], num_features=wide)}, tmodel.task),
        device="cpu",
    )
    bad = GameModel(coordinates={"x": object()}, task=TTask.LOGISTIC_REGRESSION)
    with pytest.raises(UnsupportedModelLayout, match="unknown coordinate model"):
        GameScorer(bad, device="cpu")
    assert tscoring.score_batch_rows(None) == tscoring.DEFAULT_BATCH_ROWS
    monkeypatch.setenv("PHOTON_SCORE_BATCH_ROWS", "64")
    assert GameScorer(tmodel, device="cpu", batch_rows=512).batch_rows == 64
    monkeypatch.setenv("PHOTON_SCORE_BATCH_ROWS", "0")
    with pytest.raises(ValueError):
        tscoring.score_batch_rows(8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GameTransformer(tmodel, TTask.LOGISTIC_REGRESSION)


def test_carry_over_refusals(models):
    _, tmodel, _, _ = models
    user, item = tmodel["user"], tmodel["item"]
    with pytest.raises(ValueError, match="feature dimension"):
        merge_random_effect_carryover(item, dataclasses.replace(item, num_features=99))
    with pytest.raises(ValueError, match="random-projection matrix"):
        merge_random_effect_carryover(
            user, dataclasses.replace(user, projection_matrix=user.projection_matrix + 1.0)
        )
    assert merge_random_effect_carryover(item, item) is item
    assert isinstance(tmodel["mf"], MatrixFactorizationModel)
