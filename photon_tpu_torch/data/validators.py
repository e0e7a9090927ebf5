"""Input data validation.

Host copy of photon_tpu/data/validators.py (reference
DataValidators.scala:36-183): per-task checks of labels, features, offsets
and weights, over all rows, a sample, or none.
"""
from __future__ import annotations

import enum

import numpy as np

from photon_tpu_torch.data.dataset import DataSet
from photon_tpu_torch.types import TaskType


class DataValidationType(enum.Enum):
    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class DataValidationError(ValueError):
    pass


def _sample(data: DataSet, fraction: float = 0.1, seed: int = 0) -> DataSet:
    rng = np.random.default_rng(seed)
    n = data.num_samples
    k = max(1, int(n * fraction))
    return data.take(np.sort(rng.choice(n, size=k, replace=False)))


def validate(
    data: DataSet,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    """Raise DataValidationError on the first failed check.

    Checks (mirroring DataValidators.scala): finite features; finite
    offsets; positive weights; finite labels; binary {0,1} labels for
    classification; non-negative labels for Poisson.
    """
    if mode == DataValidationType.VALIDATE_DISABLED:
        return
    if mode == DataValidationType.VALIDATE_SAMPLE:
        data = _sample(data)

    errors = []
    if not np.all(np.isfinite(data.values)):
        errors.append("features contain non-finite values")
    if not np.all(np.isfinite(data.offsets)):
        errors.append("offsets contain non-finite values")
    if not np.all(np.isfinite(data.labels)):
        errors.append("labels contain non-finite values")
    if not np.all(data.weights > 0):
        errors.append("weights must be strictly positive")

    if task.is_classification:
        # One convention per dataset: {0,1} or {-1,1}, not a mixture.
        present = set(np.unique(data.labels))
        if not (present <= {0.0, 1.0} or present <= {-1.0, 1.0}):
            errors.append(f"{task.value} requires binary labels in {{0,1}} or {{-1,1}}")
    elif task == TaskType.POISSON_REGRESSION:
        if not np.all(data.labels >= 0):
            errors.append("POISSON_REGRESSION requires non-negative labels")

    if errors:
        raise DataValidationError("; ".join(errors))


def validate_game_data(
    game_data,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    """Validate every feature shard of a GameData with the shared label,
    offset and weight columns (reference
    DataValidators.sanityCheckDataFrameForTraining)."""
    if mode == DataValidationType.VALIDATE_DISABLED:
        return
    for shard in game_data.feature_shards:
        try:
            validate(game_data.shard_dataset(shard), task, mode)
        except DataValidationError as e:
            raise DataValidationError(f"shard {shard!r}: {e}") from None
