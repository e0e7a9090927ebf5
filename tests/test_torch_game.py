"""Port parity: the GLMix slice end to end against the JAX package.

A config-5-shaped model at a small size (n=2^11, sparse fixed effect with
d=2^10 and 8 nonzeros per row through the window layout, per-user and
per-item random effects at d=4) is built and fitted by both packages at
float64: RE bucket arrays must be identical, a 2-sweep fit must give the
same FE and per-entity RE coefficients (rtol 1e-7), and the port's scorer
on a model carried across by ``game_model_from_numpy`` must match the JAX
scorer (rtol 1e-5: the JAX scorer computes in float32).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.game.scoring import GameScorer as JScorer
from photon_tpu.optimize import problem as jprob
from photon_tpu.optimize.common import OptimizerConfig as JOptConfig
from photon_tpu.types import OptimizerType as JOpt
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.convert import game_model_from_numpy
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.game.scoring import GameScorer as TScorer
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.optimize.common import OptimizerConfig as TOptConfig
from photon_tpu_torch.types import OptimizerType as TOpt
from photon_tpu_torch.types import TaskType as TTask

N, FE_DIM, FE_NNZ = 1 << 11, 1 << 10, 8
COORDS = [("user", 64, 4, 32), ("item", 16, 4, 128)]
FE_ITERS, RE_ITERS = 10, 5


def _arrays(seed=0, sparse_re=False):
    """numpy arrays of a config-5-shaped dataset (bench.py generator)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(1, FE_DIM, size=N * FE_NNZ).astype(np.int32)
    cols[::FE_NNZ] = 0
    vals = rng.normal(size=N * FE_NNZ) / np.sqrt(FE_NNZ)
    vals[::FE_NNZ] = 1.0
    margin = (vals * (rng.normal(size=FE_DIM) * 0.3)[cols]).reshape(N, FE_NNZ).sum(1)
    labels = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    shards = {"global": (np.arange(N + 1) * FE_NNZ, cols, vals, FE_DIM)}
    ids = {}
    for name, ne, d_re, _ in COORDS:
        e = (rng.zipf(1.3, size=N) - 1) % ne
        e[:ne] = rng.permutation(ne)
        ids[name] = np.array([f"{name[0]}{i}" for i in e])
        # float32-exact values: the RE build stores float32 blocks
        x = rng.normal(size=(N, d_re)).astype(np.float32).astype(np.float64)
        if sparse_re:
            x[rng.uniform(size=x.shape) < 0.4] = 0.0
        mask = x != 0
        indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
        shards[f"per_{name}"] = (indptr, np.nonzero(mask)[1].astype(np.int32), x[mask], d_re)
    offsets = 0.1 * rng.normal(size=N)
    return labels, offsets, shards, ids


def _game_data(pkg, arrays):
    labels, offsets, shards, ids = arrays
    return pkg.GameData.build(
        labels,
        {k: pkg.CSRMatrix(*v) for k, v in shards.items()},
        offsets=offsets,
        id_tags=ids,
    )


def _configs(cfg, prob, OptConfig, task):
    l2 = prob.RegularizationContext(prob.RegularizationType.L2)
    out = {
        "fixed": cfg.FixedEffectCoordinateConfig(
            feature_shard="global",
            optimization=prob.GLMProblemConfig(
                task=task,
                optimizer_config=OptConfig(max_iterations=FE_ITERS, ls_max_iterations=10),
                regularization=l2,
            ),
            regularization_weights=(1.0,),
            representation=cfg.FeatureRepresentation.SPARSE,
        )
    }
    for name, _, _, ub in COORDS:
        out[name] = cfg.RandomEffectCoordinateConfig(
            random_effect_type=name,
            feature_shard=f"per_{name}",
            optimization=prob.GLMProblemConfig(
                task=task,
                optimizer_config=OptConfig(max_iterations=RE_ITERS, ls_max_iterations=8),
                regularization=l2,
            ),
            regularization_weights=(1.0,),
            active_data_upper_bound=ub,
        )
    return out


def _jax_configs():
    return _configs(jcfg, jprob, JOptConfig, JTask.LOGISTIC_REGRESSION)


def _torch_configs():
    cfgs = _configs(tcfg, tprob, TOptConfig, TTask.LOGISTIC_REGRESSION)
    cfgs["fixed"] = dataclasses.replace(cfgs["fixed"], column_windows=True)
    return cfgs


UPDATE = ["fixed", "user", "item"]


@pytest.fixture(scope="module")
def fits():
    arrays = _arrays()
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    with pytest.MonkeyPatch.context() as mp:
        # windows on the JAX side too (its CPU default builds none)
        mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
        jres = JEstimator(
            task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
            update_sequence=UPDATE, descent_iterations=2, dtype=jnp.float64,
        ).fit(jd)[0]
    tres = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
        update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64,
        device="cpu",
    ).fit(td)[0]
    return jd, td, jres, tres


def _entity_coefs(model):
    out = {}
    for b in model.buckets:
        for i, e in enumerate(np.asarray(b.entity_ids)):
            out[str(model.vocab[e])] = (
                np.asarray(b.col_index)[i],
                np.asarray(b.coefficients, dtype=np.float64)[i],
            )
    return out


@pytest.mark.parametrize("sparse_re", [False, True], ids=["dense-re", "sparse-re"])
@pytest.mark.parametrize("coord", [c[0] for c in COORDS])
def test_re_buckets_identical_to_jax(coord, sparse_re):
    arrays = _arrays(seed=5, sparse_re=sparse_re)
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    jpool = JEstimator(
        task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
        update_sequence=UPDATE,
    )._build_shape_pool(jd)
    tpool = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
        update_sequence=UPDATE, device="cpu",
    )._build_shape_pool(td)
    assert (jpool is None) == (tpool is None) == sparse_re
    jds = jdata.build_random_effect_dataset(jd, _jax_configs()[coord], seed=3, shape_pool=jpool)
    tds = tdata.build_random_effect_dataset(td, _torch_configs()[coord], seed=3, shape_pool=tpool)
    np.testing.assert_array_equal(tds.vocab, jds.vocab)
    assert len(tds.buckets) == len(jds.buckets) > 1
    for jb, tb in zip(jds.buckets, tds.buckets):
        for f in (
            "features", "labels", "offsets", "weights", "active_mask", "col_index",
            "sample_pos", "entity_ids", "score_feats", "score_slot", "score_pos",
        ):
            a, b = getattr(jb, f), getattr(tb, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_fit_fixed_effect_matches_jax(fits):
    _, _, jres, tres = fits
    want = np.asarray(jres.model.coordinates["fixed"].model.coefficients.means)
    got = tres.model.coordinates["fixed"].coefficients.means
    assert got.shape == (FE_DIM,)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("coord", [c[0] for c in COORDS])
def test_fit_random_effect_matches_jax(fits, coord):
    _, _, jres, tres = fits
    want = _entity_coefs(jres.model.coordinates[coord])
    got = _entity_coefs(tres.model.coordinates[coord])
    assert set(got) == set(want)
    for key, (cols, coefs) in want.items():
        np.testing.assert_array_equal(got[key][0], cols)
        np.testing.assert_allclose(got[key][1], coefs, rtol=1e-7, atol=1e-10, err_msg=key)


def test_fit_scores_are_the_model_margins(fits):
    """The fit's final total equals the model's margins on its own data."""
    _, td, _, tres = fits
    scorer = TScorer(tres.model, device="cpu", dtype=torch.float64, batch_rows=512)
    np.testing.assert_allclose(
        scorer.score_data(td) - td.offsets, tres.scores, rtol=1e-10, atol=1e-10
    )


def _numpy_model(jmodel):
    coords = {}
    for cid, cm in jmodel.coordinates.items():
        if cid == "fixed":
            coords[cid] = {
                "feature_shard": cm.feature_shard,
                "means": np.asarray(cm.model.coefficients.means),
            }
        else:
            coords[cid] = {
                "random_effect_type": cm.random_effect_type,
                "feature_shard": cm.feature_shard,
                "vocab": np.asarray(cm.vocab),
                "num_features": cm.num_features,
                "buckets": [
                    {
                        "entity_ids": np.asarray(b.entity_ids),
                        "col_index": np.asarray(b.col_index),
                        "coefficients": np.asarray(b.coefficients),
                    }
                    for b in cm.buckets
                ],
            }
    return game_model_from_numpy(TTask.LOGISTIC_REGRESSION, coords)


def test_scorer_matches_jax_scorer(fits):
    jd, td, jres, _ = fits
    want = np.asarray(JScorer(jres.model, batch_rows=512).score_data(jd))
    got = TScorer(
        _numpy_model(jres.model), device="cpu", dtype=torch.float64, batch_rows=512
    ).score_data(td)
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _tron_owlqn_configs(cfg, prob, OptConfig, Opt, task):
    """TRON (L2) on the fixed effect, OWL-QN (elastic net) per user."""
    out = _configs(cfg, prob, OptConfig, task)
    out["fixed"] = dataclasses.replace(
        out["fixed"],
        optimization=dataclasses.replace(
            out["fixed"].optimization, optimizer=Opt.TRON, optimizer_config=OptConfig()
        ),
    )
    out["user"] = dataclasses.replace(
        out["user"],
        optimization=dataclasses.replace(
            out["user"].optimization,
            optimizer=Opt.OWLQN,
            regularization=prob.RegularizationContext(
                prob.RegularizationType.ELASTIC_NET, elastic_net_alpha=0.5
            ),
        ),
        regularization_weights=(2.0,),
    )
    del out["item"]
    return out


def test_tron_and_owlqn_coordinates_match_jax():
    arrays = _arrays(seed=2)
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    jcfgs = _tron_owlqn_configs(jcfg, jprob, JOptConfig, JOpt, JTask.LOGISTIC_REGRESSION)
    tcfgs = _tron_owlqn_configs(tcfg, tprob, TOptConfig, TOpt, TTask.LOGISTIC_REGRESSION)
    tcfgs["fixed"] = dataclasses.replace(tcfgs["fixed"], column_windows=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
        jres = JEstimator(
            task=JTask.LOGISTIC_REGRESSION, coordinate_configs=jcfgs,
            update_sequence=["fixed", "user"], descent_iterations=2, dtype=jnp.float64,
        ).fit(jd)[0]
    tres = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=tcfgs,
        update_sequence=["fixed", "user"], descent_iterations=2, dtype=torch.float64,
        device="cpu",
    ).fit(td)[0]
    np.testing.assert_allclose(
        tres.model.coordinates["fixed"].coefficients.means,
        np.asarray(jres.model.coordinates["fixed"].model.coefficients.means),
        rtol=1e-7, atol=1e-10,
    )
    want = _entity_coefs(jres.model.coordinates["user"])
    got = _entity_coefs(tres.model.coordinates["user"])
    assert set(got) == set(want)
    n_zero = 0
    for key, (cols, coefs) in want.items():
        np.testing.assert_array_equal(got[key][0], cols)
        np.testing.assert_allclose(got[key][1], coefs, rtol=1e-7, atol=1e-10, err_msg=key)
        np.testing.assert_array_equal(got[key][1] == 0, coefs == 0, err_msg=key)
        n_zero += int((coefs == 0).sum())
    assert n_zero > 0  # the L1 part zeroes some per-user coefficients


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEstimator(
            task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
            update_sequence=UPDATE,
        )
    model = game_model_from_numpy(
        TTask.LOGISTIC_REGRESSION, {"fixed": {"feature_shard": "global", "means": np.zeros(4)}}
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TScorer(model)
