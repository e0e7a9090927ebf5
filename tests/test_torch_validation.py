"""Port parity of per-sweep validation and grouped evaluation (mirrors
tests/test_validation.py and tests/test_evaluation.py:67-150).

The device validation scorer must give the metric that GameTransformer
computes from the returned (best-sweep) model, and the metric JAX's fit
reports, at 1e-9, for every projector and with an MF coordinate; the
grouped device metrics must match the per-group host loop and JAX's
kernels; and the returned model must be the best sweep's, not the last.
Float64 on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from photon_tpu.evaluation import multi as jmulti
from photon_tpu.evaluation.evaluators import EvaluatorType as JEval
from photon_tpu.game import data as jdata
from photon_tpu.game.transformer import GameTransformer as JTransformer
from photon_tpu_torch.evaluation import multi as tmulti
from photon_tpu_torch.evaluation.evaluators import EvaluatorType as TEval
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.coordinate import Coordinate
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.game.transformer import GameTransformer as TTransformer
from test_torch_game import (
    assert_models_close,
    fit_pair,
    small_arrays,
    small_configs,
    small_data,
)

EVALUATORS = {
    "AUC": (JEval.AUC, TEval.AUC),
    "LOGISTIC_LOSS": (JEval.LOGISTIC_LOSS, TEval.LOGISTIC_LOSS),
}


def _evaluator(side, name):
    if ":" in name:
        mod = jmulti if side == "jax" else tmulti
        return mod.parse_grouped_evaluator(name)
    return EVALUATORS[name][0 if side == "jax" else 1]


def _fit_with_validation(coords, evaluator, replace=None, iters=2, flip=False, train_seed=0):
    arrays = small_arrays(seed=train_seed)
    valid = small_arrays(seed=11, users=32, items=10)  # unseen users and items
    if flip:
        valid = (1.0 - valid[0],) + valid[1:]
    vdata = {"jax": small_data(jdata, valid), "torch": small_data(tdata, valid)}
    jres, tres, _, _ = fit_pair(
        coords, arrays=arrays, iters=iters, replace=replace,
        est_kw=lambda side, d: {"validation_evaluator": _evaluator(side, evaluator)},
        fit_kw=lambda side, d: {"validation_data": vdata[side]},
    )
    return jres[0], tres[0], vdata


@pytest.mark.parametrize("projector", ["INDEX_MAP", "RANDOM", "IDENTITY"])
def test_device_validation_matches_transformer_and_jax(projector):
    replace = {"user": {"projector_type": lambda m: getattr(m.ProjectorType, projector),
                        "random_projection_dim": 4}}
    jres, tres, vdata = _fit_with_validation(("fixed", "user"), "AUC", replace)
    assert tres.evaluation is not None
    via_model = TTransformer(tres.model, tres.model.task, device="cpu").evaluate(
        vdata["torch"], TEval.AUC
    )
    np.testing.assert_allclose(tres.evaluation, via_model, rtol=1e-9)
    np.testing.assert_allclose(tres.evaluation, jres.evaluation, rtol=1e-9)
    np.testing.assert_allclose(
        via_model, JTransformer(jres.model, jres.model.task).evaluate(vdata["jax"], JEval.AUC),
        rtol=1e-9,
    )


def test_device_validation_with_mf_matches_transformer_and_jax():
    jres, tres, vdata = _fit_with_validation(("fixed", "mf"), "LOGISTIC_LOSS")
    via_model = TTransformer(tres.model, tres.model.task, device="cpu").evaluate(
        vdata["torch"], TEval.LOGISTIC_LOSS
    )
    np.testing.assert_allclose(tres.evaluation, via_model, rtol=1e-9)
    np.testing.assert_allclose(tres.evaluation, jres.evaluation, rtol=1e-9)


@pytest.mark.parametrize("spec", ["AUC:user", "PRECISION@3:user", "RMSE:item"])
def test_grouped_validation_matches_transformer_and_jax(spec):
    jres, tres, vdata = _fit_with_validation(("fixed", "user"), spec)
    parsed = tmulti.parse_grouped_evaluator(spec)
    via_model = TTransformer(tres.model, tres.model.task, device="cpu").evaluate_grouped(
        vdata["torch"], parsed.build(device="cpu"), parsed.id_tag
    )
    np.testing.assert_allclose(tres.evaluation, via_model, rtol=1e-9)
    np.testing.assert_allclose(tres.evaluation, jres.evaluation, rtol=1e-9)


def test_best_sweep_model_is_returned_not_the_last():
    """Validation labels flipped: the metric falls as the model learns, so
    sweep 0 is best. The returned model equals a one-sweep fit, differs
    from the last sweep's states, and matches JAX's choice."""
    jres, tres, _ = _fit_with_validation(("fixed", "user"), "AUC", iters=3, flip=True)
    vals = [r["validation"] for r in tres.tracker if "validation" in r]
    assert len(vals) == 3 and int(np.argmax(vals)) == 0 and vals[0] > vals[-1]
    assert tres.evaluation == vals[0]
    assert_models_close(jres.model, tres.model)
    one_sweep, three_sweeps = (_port_fit(iters) for iters in (1, 3))
    assert_models_close(jres.model, one_sweep.model)
    assert not np.allclose(
        three_sweeps.model["fixed"].coefficients.means, tres.model["fixed"].coefficients.means
    )
    np.testing.assert_allclose(tres.scores, tres.model.score(small_data(tdata, small_arrays())),
                               rtol=1e-9, atol=1e-9)


def _port_fit(iters):
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=small_configs("torch"),
        update_sequence=["fixed", "user"], descent_iterations=iters, dtype=torch.float64,
        device="cpu",
    ).fit(small_data(tdata, small_arrays()))[0]


@dataclasses.dataclass(eq=False)
class _Counter(Coordinate):
    """A coordinate whose state is one tensor updated IN PLACE each step."""

    w: torch.Tensor

    def initial_state(self):
        return self.w

    def train(self, residual, state):
        state.add_(1.0)  # in place: a snapshot that is a view would follow
        return state, None

    def score(self, state):
        return state.expand(4).clone()


def test_best_snapshot_is_a_clone_of_in_place_states():
    metrics = iter([0.9, 0.5, 0.1])
    cd = run_coordinate_descent(
        {"c": _Counter(torch.zeros(1, dtype=torch.float64))}, ["c"], 3,
        validation_fn=lambda states: next(metrics),
    )
    assert float(cd.states["c"]) == 3.0
    assert float(cd.best_states["c"]) == 1.0 and cd.best_metric == 0.9


@pytest.mark.parametrize("kind", ["auc", "rmse", "p@k"])
def test_grouped_device_matches_host_loop_and_jax(kind):
    """Skewed groups with score ties and single-class groups (AUC skips
    them); precision@k on untied scores, since its ties are order-bound."""
    rng = np.random.default_rng(0)
    n, n_groups = 5000, 130
    groups = np.array([f"q{g}" for g in rng.integers(0, n_groups, size=n)])
    scores = np.round(rng.normal(size=n), 1)
    labels = (rng.uniform(size=n) < 0.3).astype(np.float64)
    labels[groups == "q0"] = 1.0
    labels[groups == "q1"] = 0.0
    if kind == "p@k":
        scores = scores + rng.uniform(0, 1e-4, size=n)
    make = {
        "auc": lambda m, **kw: m.MultiEvaluator.auc(**kw),
        "rmse": lambda m, **kw: m.MultiEvaluator.rmse(**kw),
        "p@k": lambda m, **kw: m.MultiEvaluator.precision_at_k(5, **kw),
    }[kind]
    ev = make(tmulti, device="cpu")
    dev = ev(scores, labels, groups)
    host = dataclasses.replace(ev, device_kind=None)(scores, labels, groups)
    np.testing.assert_allclose(dev, host, rtol=1e-9)
    np.testing.assert_allclose(dev, make(jmulti)(scores, labels, groups), rtol=1e-9)


def test_grouped_edge_cases():
    ev = tmulti.MultiEvaluator
    np.testing.assert_allclose(
        ev.auc(device="cpu")(np.array([0.9, 0.1, 0.1, 0.9]), np.array([1.0, 0, 1, 0]),
                             np.array(["a", "a", "b", "b"])), 0.5)
    np.testing.assert_allclose(
        ev.auc(device="cpu")(np.array([0.9, 0.1, 0.5, 0.6]), np.array([1.0, 0, 1, 1]),
                             np.array(["a", "a", "b", "b"])), 1.0)
    np.testing.assert_allclose(
        ev.precision_at_k(10, device="cpu")(np.array([0.9, 0.1, 0.5]), np.array([1.0, 0, 1]),
                                            np.array(["a", "a", "b"])), 0.75)
    assert np.isnan(ev.auc(device="cpu")(np.array([0.1, 0.2]), np.array([1.0, 1.0]),
                                         np.array(["a", "b"])))
    spec = tmulti.parse_grouped_evaluator("PRECISION@5:documentId")
    assert (spec.kind, spec.k, spec.id_tag, spec.name) == (
        "PRECISION_AT_K", 5, "documentId", "PRECISION@5:documentId")
    assert not tmulti.parse_grouped_evaluator("RMSE:q").larger_is_better
    assert tmulti.parse_grouped_evaluator("AUC") is None
    for bad in ("AUC:", "PRECISION@0:q", "PRECISION@x:q", "LOSS:q"):
        with pytest.raises(ValueError):
            tmulti.parse_grouped_evaluator(bad)
    assert tmulti.build_multi_evaluator(TEval.AUC, "q", device="cpu").name == "AUC@q"
    with pytest.raises(ValueError):
        tmulti.build_multi_evaluator(TEval.AUPR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ev.auc()(np.array([0.1, 0.2]), np.array([1.0, 0.0]), np.array(["a", "a"]))
