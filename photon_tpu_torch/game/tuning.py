"""GAME hyperparameter tuning glue: vectorize a GAME config ↔ [0,1]^d and run
one full training per candidate.

Copy of photon_tpu/game/tuning.py over the port's estimator.

Reference parity: photon-client estimators/GameEstimatorEvaluationFunction
.scala:52-170 (regularization weights searched on log10 scale, one dimension
per tunable coordinate in update-sequence order) and
GameTrainingDriver.runHyperparameterTuning (GameTrainingDriver.scala:631-668).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from photon_tpu_torch.game.data import GameData
from photon_tpu_torch.game.estimator import GameEstimator, GameTrainingResult
from photon_tpu_torch.hyperparameter.evaluation import (
    EvaluationFunction,
    HyperparameterScale,
    rescale_backward,
    rescale_forward,
)
from photon_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
)

# Default search range for regularization weights, log10 scale (reference
# GameEstimatorEvaluationFunction: weights tuned in log space).
DEFAULT_REG_RANGE = (1e-4, 1e4)


class GameEstimatorEvaluationFunction(EvaluationFunction[GameTrainingResult]):
    """Evaluates one hyperparameter candidate = one GAME training run.

    The candidate vector holds one [0,1] value per tunable coordinate
    (update-sequence order), mapped onto the coordinate's regularization
    weight on log10 scale.
    """

    def __init__(
        self,
        estimator: GameEstimator,
        train_data: GameData,
        validation_data: GameData,
        reg_ranges: Mapping[str, tuple[float, float]] | None = None,
        tunable_coordinates: Sequence[str] | None = None,
    ):
        if estimator.validation_evaluator is None:
            raise ValueError("tuning requires a validation evaluator")
        self.estimator = estimator
        self.train_data = train_data
        self.validation_data = validation_data
        self.tunable = list(
            tunable_coordinates
            if tunable_coordinates is not None
            else [
                c
                for c in estimator.update_sequence
                if c not in estimator.locked_coordinates
            ]
        )
        ranges = reg_ranges or {}
        self.ranges = [
            (*ranges.get(cid, DEFAULT_REG_RANGE), HyperparameterScale.LOG)
            for cid in self.tunable
        ]

    @property
    def num_params(self) -> int:
        return len(self.tunable)

    def candidate_to_weights(self, candidate: np.ndarray) -> dict[str, float]:
        reg = rescale_backward(np.asarray(candidate, float), self.ranges)
        return dict(zip(self.tunable, reg))

    def weights_to_candidate(self, weights: Mapping[str, float]) -> np.ndarray:
        vals = np.array([weights[cid] for cid in self.tunable])
        return rescale_forward(vals, self.ranges)

    def __call__(self, candidate: np.ndarray):
        weights = self.candidate_to_weights(candidate)
        configs = {
            cid: dataclasses.replace(
                cfg,
                regularization_weights=(
                    (weights[cid],) if cid in weights
                    else cfg.regularization_weights
                ),
            )
            for cid, cfg in self.estimator.coordinate_configs.items()
        }
        estimator = dataclasses.replace(
            self.estimator,
            coordinate_configs=configs,
            # tuning refits train from scratch (no initial model), so the
            # warm-start-only threshold bypass must not carry over
            ignore_threshold_for_new_models=False,
            # internal exploratory fits: don't re-emit the lifecycle
            # setup/training_finish events once per tuning candidate —
            # listeners on the parent estimator's bus see one fit
            events=None,
        )
        results = estimator.fit(
            self.train_data, validation_data=self.validation_data
        )
        result = results[-1]
        assert result.evaluation is not None
        return float(result.evaluation), result

    def convert_observations(self, results):
        out = []
        for r in results:
            out.append(
                (
                    self.weights_to_candidate(r.regularization_weights),
                    float(r.evaluation),
                )
            )
        return out


def run_hyperparameter_tuning(
    estimator: GameEstimator,
    train_data: GameData,
    validation_data: GameData,
    *,
    num_iterations: int,
    mode: str = "BAYESIAN",
    reg_ranges: Mapping[str, tuple[float, float]] | None = None,
    prior_observations: Sequence[tuple[np.ndarray, float]] = (),
    prior_json: str | None = None,
    shrink_radius: float | None = None,
    seed: int = 0,
) -> list[GameTrainingResult]:
    """Bayesian or random search over regularization weights (reference
    GameTrainingDriver.runHyperparameterTuning :631-668).

    ``prior_json`` carries serialized observations from earlier jobs
    (reference HyperparameterSerialization.priorFromJson); with
    ``shrink_radius`` set, the search box first contracts around the
    GP-predicted best prior region (reference ShrinkSearchRange.getBounds).
    """
    fn = GameEstimatorEvaluationFunction(
        estimator, train_data, validation_data, reg_ranges
    )
    maximize = estimator.validation_evaluator.larger_is_better
    prior_observations = list(prior_observations)
    if prior_json is not None:
        from photon_tpu_torch.hyperparameter.serialization import (
            priors_from_json,
            shrink_search_range,
        )

        defaults = {
            cid: float(
                estimator.coordinate_configs[cid].regularization_weights[0]
            )
            for cid in fn.tunable
        }
        parsed = priors_from_json(prior_json, fn.tunable, defaults)
        if shrink_radius is not None and parsed:
            pts01 = np.stack(
                [fn.weights_to_candidate(p) for p, _ in parsed]
            )
            vals = np.array([v for _, v in parsed])
            lo01, hi01 = shrink_search_range(
                pts01,
                vals,
                radius=shrink_radius,
                maximize=maximize,
                seed=seed,
            )
            lo = rescale_backward(lo01, fn.ranges)
            hi = rescale_backward(hi01, fn.ranges)
            new_ranges = {
                cid: (float(lo[i]), float(hi[i]))
                for i, cid in enumerate(fn.tunable)
            }
            fn = GameEstimatorEvaluationFunction(
                estimator, train_data, validation_data, new_ranges
            )
        for params, value in parsed:
            cand = fn.weights_to_candidate(params)
            # priors outside the (possibly shrunk) box are DROPPED — clipping
            # them onto the boundary would attribute their evaluations to
            # points where they were never measured
            if np.all((cand >= 0.0) & (cand <= 1.0)):
                prior_observations.append((cand, float(value)))
    if mode.upper() == "BAYESIAN":
        search: RandomSearch = GaussianProcessSearch(
            fn.num_params, fn, seed=seed, maximize=maximize
        )
    elif mode.upper() == "RANDOM":
        search = RandomSearch(fn.num_params, fn, seed=seed, maximize=maximize)
    else:
        raise ValueError(f"unknown tuning mode {mode!r}")
    return search.find_with_prior_observations(
        num_iterations, list(prior_observations)
    )
