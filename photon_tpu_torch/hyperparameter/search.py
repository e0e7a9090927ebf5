"""Random and Bayesian (GP) hyperparameter search over the unit hypercube.

Reference: photon-lib hyperparameter/search/RandomSearch.scala:61-183 and
GaussianProcessSearch.scala:60-205. Candidates are quasi-random Sobol points
in [0,1]^d; the GP search fits a GaussianProcessModel to (mean-centered)
observations and picks the candidate maximizing expected improvement.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from photon_tpu_torch.hyperparameter.criteria import expected_improvement
from photon_tpu_torch.hyperparameter.evaluation import EvaluationFunction
from photon_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_tpu_torch.hyperparameter.kernels import Matern52, StationaryKernel
from photon_tpu_torch.hyperparameter.qmc_compat import sobol_engine

Observation = tuple[np.ndarray, float]


class RandomSearch:
    """Quasi-random (Sobol) search (reference RandomSearch.scala)."""

    def __init__(
        self,
        num_params: int,
        evaluation_function: EvaluationFunction,
        discrete_params: dict[int, int] | None = None,
        kernel: StationaryKernel | None = None,
        seed: int = 0,
        maximize: bool = True,
    ):
        if num_params <= 0:
            raise ValueError("num_params must be positive")
        self.num_params = num_params
        self.evaluation_function = evaluation_function
        self.discrete_params = dict(discrete_params or {})
        self.kernel = kernel if kernel is not None else Matern52()
        self.seed = seed
        self.maximize = maximize
        self._sobol = sobol_engine(num_params, scramble=True, seed=seed)

    # --- public API -------------------------------------------------------

    def find(self, n: int) -> list:
        return self.find_with_prior_observations(n, [])

    def find_with_prior_observations(
        self, n: int, prior_observations: Sequence[Observation]
    ) -> list:
        """Evaluate one Sobol point to seed the loop, then continue with
        ``find_with_priors`` (reference findWithPriorObservations)."""
        if n <= 0:
            raise ValueError("n must be positive")
        candidate = self._discretize(self._draw_candidates(1)[0])
        _, result = self.evaluation_function(candidate)
        if n == 1:
            return [result]
        observations = self.evaluation_function.convert_observations([result])
        return [result] + self.find_with_priors(
            n - 1, observations, prior_observations
        )

    def find_with_priors(
        self,
        n: int,
        observations: Sequence[Observation],
        prior_observations: Sequence[Observation] = (),
    ) -> list:
        """n search iterations seeded with existing observations (reference
        findWithPriors)."""
        if n <= 0:
            raise ValueError("n must be positive")
        if not observations:
            raise ValueError("at least one observation required")
        for point, value in list(observations)[:-1]:
            self._on_observation(np.asarray(point, float), value)
        for point, value in prior_observations:
            self._on_prior_observation(np.asarray(point, float), value)

        results = []
        last_candidate, last_value = observations[-1]
        last_candidate = np.asarray(last_candidate, float)
        for _ in range(n):
            candidate = self._discretize(
                self._next(last_candidate, last_value)
            )
            value, result = self.evaluation_function(candidate)
            results.append(result)
            last_candidate, last_value = candidate, value
        return results

    # --- extension points -------------------------------------------------

    def _next(self, last_candidate: np.ndarray, last_value: float) -> np.ndarray:
        return self._draw_candidates(1)[0]

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        pass

    def _on_prior_observation(self, point: np.ndarray, value: float) -> None:
        pass

    # --- helpers ----------------------------------------------------------

    def _draw_candidates(self, n: int) -> np.ndarray:
        return self._sobol.random(n)

    def _discretize(self, candidate: np.ndarray) -> np.ndarray:
        """Snap configured dimensions onto a discrete grid (reference
        discretizeCandidate)."""
        out = candidate.copy()
        for idx, num_values in self.discrete_params.items():
            out[idx] = math.floor(candidate[idx] * num_values) / num_values
        return out


class GaussianProcessSearch(RandomSearch):
    """Bayesian search: GP posterior + expected improvement over a Sobol
    candidate pool (reference GaussianProcessSearch.scala)."""

    def __init__(
        self,
        num_params: int,
        evaluation_function: EvaluationFunction,
        discrete_params: dict[int, int] | None = None,
        kernel: StationaryKernel | None = None,
        candidate_pool_size: int = 250,
        noisy_target: bool = True,
        seed: int = 0,
        maximize: bool = True,
    ):
        super().__init__(
            num_params, evaluation_function, discrete_params, kernel, seed,
            maximize,
        )
        self.candidate_pool_size = candidate_pool_size
        self.noisy_target = noisy_target
        self._points: list[np.ndarray] = []
        self._evals: list[float] = []
        self._prior_points: list[np.ndarray] = []
        self._prior_evals: list[float] = []
        self._best = -np.inf if maximize else np.inf
        self._prior_best = -np.inf if maximize else np.inf
        self.last_model: GaussianProcessModel | None = None

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.maximize else a < b

    def _next(self, last_candidate: np.ndarray, last_value: float) -> np.ndarray:
        self._on_observation(last_candidate, last_value)
        # Under-determined GP → uniform fallback (reference next():128).
        if len(self._points) <= self.num_params:
            return super()._next(last_candidate, last_value)

        candidates = self._draw_candidates(self.candidate_pool_size)
        points = np.stack(self._points)
        evals = np.asarray(self._evals)
        current_mean = float(np.mean(evals))
        centered_best = self._best - current_mean
        overall_best = (
            self._prior_best
            if self._better(self._prior_best, centered_best)
            else centered_best
        )

        transformation = expected_improvement(overall_best, self.maximize)
        estimator = GaussianProcessEstimator(
            kernel=self.kernel,
            normalize_labels=False,
            noisy_target=self.noisy_target,
            transformation=transformation,
            seed=self.seed,
        )
        if self._prior_points:
            all_points = np.vstack([points, np.stack(self._prior_points)])
            all_evals = np.concatenate(
                [evals - current_mean, np.asarray(self._prior_evals)]
            )
        else:
            all_points, all_evals = points, evals - current_mean

        model = estimator.fit(all_points, all_evals)
        self.last_model = model
        predictions = model.predict_transformed(candidates)
        # EI is always maximized (transformation.is_max_opt).
        best_idx = int(np.argmax(predictions))
        return candidates[best_idx]

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        self._points.append(np.asarray(point, float))
        self._evals.append(float(value))
        if self._better(value, self._best):
            self._best = value

    def _on_prior_observation(self, point: np.ndarray, value: float) -> None:
        self._prior_points.append(np.asarray(point, float))
        self._prior_evals.append(float(value))
        if self._better(value, self._prior_best):
            self._prior_best = value
