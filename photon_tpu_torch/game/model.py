"""GAME model containers: fixed effect, random effect, combined.

Counterpart of photon_tpu/game/model.py (with the small pieces of
photon_tpu/models/glm.py and coefficients.py the fixed-effect model
needs). Models are host numpy: they leave the device at the end of a fit
and go back to it in the scorer (``GameScorer`` scores them).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, NamedTuple

import numpy as np

from photon_tpu_torch.types import TaskType


class Coefficients(NamedTuple):
    """Dense coefficient means (models/coefficients.py)."""

    means: np.ndarray


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """One GLM over every sample's shard features."""

    coefficients: Coefficients
    feature_shard: str
    task: TaskType


@dataclasses.dataclass(frozen=True)
class BucketCoefficients:
    """Coefficients of one RE bucket: [E, d_max] in the compacted space."""

    entity_ids: np.ndarray
    col_index: np.ndarray
    coefficients: np.ndarray


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    random_effect_type: str
    feature_shard: str
    task: TaskType
    vocab: np.ndarray
    buckets: tuple[BucketCoefficients, ...]
    num_features: int

    @functools.cached_property
    def entity_row_index(self) -> dict:
        return {k: i for i, k in enumerate(self.vocab)}


@dataclasses.dataclass(frozen=True)
class GameModel:
    """coordinate id → model, scored additively."""

    coordinates: Mapping[str, FixedEffectModel | RandomEffectModel]
    task: TaskType

    def __getitem__(self, cid: str):
        return self.coordinates[cid]
