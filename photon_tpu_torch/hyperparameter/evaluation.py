"""Evaluation-function abstraction + hyperparameter vector rescaling.

Reference: photon-lib hyperparameter/EvaluationFunction.scala and
photon-client hyperparameter/VectorRescaling.scala +
estimators/GameEstimatorEvaluationFunction.scala:52-170 (reg weights are
searched on log scale, packed into the unit hypercube).
"""
from __future__ import annotations

import abc
import enum
from typing import Any, Generic, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


class HyperparameterScale(enum.Enum):
    LINEAR = "linear"
    LOG = "log"


def rescale_forward(
    values: np.ndarray,
    ranges: Sequence[tuple[float, float, HyperparameterScale]],
) -> np.ndarray:
    """Map real hyperparameter values into [0, 1]^d (reference
    VectorRescaling.rescaleForward)."""
    out = np.zeros(len(ranges))
    for i, (lo, hi, scale) in enumerate(ranges):
        v = values[i]
        if scale is HyperparameterScale.LOG:
            lo, hi, v = np.log10(lo), np.log10(hi), np.log10(v)
        out[i] = (v - lo) / (hi - lo) if hi > lo else 0.0
    return out


def rescale_backward(
    unit: np.ndarray,
    ranges: Sequence[tuple[float, float, HyperparameterScale]],
) -> np.ndarray:
    """Map [0, 1]^d back to real hyperparameter values (reference
    VectorRescaling.rescaleBackward)."""
    out = np.zeros(len(ranges))
    for i, (lo, hi, scale) in enumerate(ranges):
        if scale is HyperparameterScale.LOG:
            llo, lhi = np.log10(lo), np.log10(hi)
            out[i] = 10.0 ** (llo + unit[i] * (lhi - llo))
        else:
            out[i] = lo + unit[i] * (hi - lo)
    return out


class EvaluationFunction(abc.ABC, Generic[T]):
    """Evaluates one point of the unit hypercube to a real score plus an
    arbitrary result payload (reference EvaluationFunction.scala)."""

    @abc.abstractmethod
    def __call__(self, candidate: np.ndarray) -> tuple[float, T]:
        """Returns (observed evaluation, result payload)."""

    def convert_observations(
        self, results: Sequence[T]
    ) -> list[tuple[np.ndarray, float]]:
        """Extracts (candidate vector, evaluation) pairs from past results
        for use as priors. Override when payloads carry them."""
        raise NotImplementedError


class CallableEvaluationFunction(EvaluationFunction[Any]):
    """Wraps a plain ``f(candidate) -> float`` for tests and simple tuning."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, candidate: np.ndarray) -> tuple[float, Any]:
        value = float(self._fn(candidate))
        return value, (np.asarray(candidate, dtype=float), value)

    def convert_observations(self, results):
        return [(vec, value) for vec, value in results]
