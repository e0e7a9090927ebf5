"""Port parity: GAME hyperparameter tuning against the JAX package.

The same tuning problems run through both packages at float64 on the
CPU: a fixed-effect linear regression tuned on RMSE, and a GLMix model
(fixed effect + per-user random effect, two tunable λ) tuned on AUC.
RANDOM tuning proposes the same candidates as JAX's and its evaluations
agree within 1e-9; BAYESIAN tuning proposes the same candidates too (its
expected-improvement argmax runs on evaluations within roundoff of
JAX's, so a flip would be a finding, not noise); priors from JSON with a
shrunk search range do as well.
"""
from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.evaluation.evaluators import EvaluatorType as JEval
from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game import tuning as jtuning
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.hyperparameter.serialization import priors_to_json
from photon_tpu.optimize import common as jcommon
from photon_tpu.optimize import problem as jprob
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.evaluation.evaluators import EvaluatorType as TEval
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game import tuning as ttuning
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.optimize import common as tcommon
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.types import TaskType as TTask

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the JAX programs this module compiled when it ends: each keeps
    memory maps of its code, and one process running many such modules
    would reach the kernel's limit on maps (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()



def _linear_arrays(seed=0, n=400, n_users=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    users = rng.integers(0, n_users, size=n)
    y = x @ np.array([1.0, -2.0, 0.5, 0.0]) + rng.normal(scale=0.1, size=n)
    return y, x, np.array([f"u{u}" for u in users])


def _glmix_arrays(seed=0, n=500, n_users=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    xu = rng.normal(size=(n, 3))
    users = np.concatenate([np.arange(n_users), rng.integers(0, n_users, size=n - n_users)])
    margin = x @ rng.normal(size=5) + np.einsum("nd,nd->n", xu, rng.normal(size=(n_users, 3))[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return y, x, xu, np.array([f"u{u}" for u in users])


def _linear(pkg, cfg, prob, common, task, ev, dtype, **kw):
    y, x, uid = _linear_arrays()
    data = pkg.GameData.build(labels=y, feature_shards={"global": pkg.CSRMatrix.from_dense(x)},
                              id_tags={"userId": uid})
    opt = prob.GLMProblemConfig(task=task.LINEAR_REGRESSION,
                                optimizer_config=common.OptimizerConfig(max_iterations=30))
    est = kw.pop("estimator")(
        task=task.LINEAR_REGRESSION,
        coordinate_configs={"fixed": cfg.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=opt, regularization_weights=(1.0,))},
        update_sequence=["fixed"], validation_evaluator=ev.RMSE, dtype=dtype, **kw,
    )
    return est, data


def _glmix(pkg, cfg, prob, common, task, ev, dtype, seed, **kw):
    y, x, xu, uid = _glmix_arrays(seed)
    data = pkg.GameData.build(
        labels=y, feature_shards={"global": pkg.CSRMatrix.from_dense(x),
                                  "per_user": pkg.CSRMatrix.from_dense(xu)},
        id_tags={"userId": uid})
    opt = prob.GLMProblemConfig(
        task=task.LOGISTIC_REGRESSION,
        regularization=prob.RegularizationContext(prob.RegularizationType.L2),
        optimizer_config=common.OptimizerConfig(max_iterations=20, ls_max_iterations=10))
    est = kw.pop("estimator")(
        task=task.LOGISTIC_REGRESSION,
        coordinate_configs={
            "fixed": cfg.FixedEffectCoordinateConfig(
                feature_shard="global", optimization=opt, regularization_weights=(1.0,)),
            "user": cfg.RandomEffectCoordinateConfig(
                random_effect_type="userId", feature_shard="per_user", optimization=opt,
                regularization_weights=(1.0,)),
        },
        update_sequence=["fixed", "user"], descent_iterations=2,
        validation_evaluator=ev.AUC, dtype=dtype, **kw,
    )
    return est, data


def _pair(problem, **kw):
    """(port estimator, train, valid), (JAX estimator, train, valid)."""
    out = []
    for pkg, cfg, prob, common, task, ev, dtype, est in (
        (tdata, tcfg, tprob, tcommon, TTask, TEval, torch.float64,
         lambda **k: TEstimator(device="cpu", **k)),
        (jdata, jcfg, jprob, jcommon, JTask, JEval, jnp.float64, JEstimator),
    ):
        if problem == "linear":
            e, train = _linear(pkg, cfg, prob, common, task, ev, dtype, estimator=est)
            valid = train
        else:
            e, train = _glmix(pkg, cfg, prob, common, task, ev, dtype, 0, estimator=est)
            _, valid = _glmix(pkg, cfg, prob, common, task, ev, dtype, 1, estimator=est)
        out.append((e, train, valid))
    return out


def _assert_same_results(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.regularization_weights.keys() == w.regularization_weights.keys()
        for k, v in w.regularization_weights.items():
            assert g.regularization_weights[k] == pytest.approx(v, rel=1e-12), k
        assert g.evaluation == pytest.approx(w.evaluation, rel=0, abs=tol)


def test_evaluation_function_equals_jax():
    (te, ttrain, tvalid), (je, jtrain, jvalid) = _pair("glmix")
    tfn = ttuning.GameEstimatorEvaluationFunction(te, ttrain, tvalid)
    jfn = jtuning.GameEstimatorEvaluationFunction(je, jtrain, jvalid)
    assert tfn.num_params == jfn.num_params == 2 and tfn.tunable == jfn.tunable
    cand = np.array([0.3, 0.65])
    assert tfn.candidate_to_weights(cand) == pytest.approx(jfn.candidate_to_weights(cand), rel=1e-15)
    np.testing.assert_allclose(tfn.weights_to_candidate(tfn.candidate_to_weights(cand)), cand,
                               atol=1e-12)
    tv, tres = tfn(cand)
    jv, jres = jfn(cand)
    assert tv == pytest.approx(jv, abs=TOL) and tres.evaluation == tv
    (tobs,), (jobs,) = tfn.convert_observations([tres]), jfn.convert_observations([jres])
    np.testing.assert_allclose(tobs[0], jobs[0], rtol=1e-12)
    assert tobs[1] == pytest.approx(jobs[1], abs=TOL)


@pytest.mark.parametrize("problem,mode", [
    ("linear", "RANDOM"), ("linear", "BAYESIAN"), ("glmix", "BAYESIAN"),
])
def test_tuning_equals_jax(problem, mode):
    (te, ttrain, tvalid), (je, jtrain, jvalid) = _pair(problem)
    got = ttuning.run_hyperparameter_tuning(te, ttrain, tvalid, num_iterations=3, mode=mode,
                                            seed=1)
    want = jtuning.run_hyperparameter_tuning(je, jtrain, jvalid, num_iterations=3, mode=mode,
                                             seed=1)
    _assert_same_results(got, want)
    assert all(np.isfinite(r.evaluation) for r in got)


def test_tuning_with_prior_json_and_shrink_equals_jax():
    (te, ttrain, tvalid), (je, jtrain, jvalid) = _pair("linear")
    prior = priors_to_json([({"fixed": 0.1}, 0.35), ({"fixed": 100.0}, 2.5),
                            ({"fixed": 0.2}, 0.36)])
    kw = dict(num_iterations=2, mode="BAYESIAN", prior_json=prior, shrink_radius=0.15, seed=0)
    got = ttuning.run_hyperparameter_tuning(te, ttrain, tvalid, **kw)
    want = jtuning.run_hyperparameter_tuning(je, jtrain, jvalid, **kw)
    _assert_same_results(got, want)
    for r in got:
        # the shrunk box sits around the good small-λ priors, far from λ=100
        assert r.regularization_weights["fixed"] < 50.0


def test_tuning_refuses_what_jax_refuses():
    (te, ttrain, tvalid), _ = _pair("linear")
    with pytest.raises(ValueError, match="unknown tuning mode"):
        ttuning.run_hyperparameter_tuning(te, ttrain, tvalid, num_iterations=1, mode="GRID")
    import dataclasses

    with pytest.raises(ValueError, match="validation evaluator"):
        ttuning.GameEstimatorEvaluationFunction(
            dataclasses.replace(te, validation_evaluator=None), ttrain, tvalid)
