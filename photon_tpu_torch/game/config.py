"""GAME coordinate configurations.

Counterpart of photon_tpu/game/config.py for the fixed- and random-effect
coordinates (index-map projection only: random projection, Pearson
feature capping and matrix factorization are not ported yet).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from photon_tpu_torch.optimize.problem import GLMProblemConfig


class FeatureRepresentation(enum.Enum):
    """DENSE keeps [N, D]; SPARSE is padded ELL; AUTO picks SPARSE when the
    dense block would be large and mostly zeros."""

    DENSE = "DENSE"
    SPARSE = "SPARSE"
    AUTO = "AUTO"


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """``column_windows``: also build the window layout for the sparse
    backward pass where the policy would not (off the card, or d < 1024);
    on a CUDA device at d ≥ 1024 it is always built."""

    feature_shard: str
    optimization: GLMProblemConfig
    regularization_weights: Sequence[float] = (0.0,)
    representation: FeatureRepresentation = FeatureRepresentation.AUTO
    column_windows: bool = False


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """Per-entity GLMs: ``active_data_upper_bound`` caps training rows per
    entity (reservoir sampling), entities below ``active_data_lower_bound``
    get no model, ``passive_data_lower_bound`` drops small passive sets,
    ``shape_budget`` caps the distinct (rows, d) bucket shapes (None →
    data.DEFAULT_SHAPE_BUDGET, 0 disables)."""

    random_effect_type: str
    feature_shard: str
    optimization: GLMProblemConfig
    regularization_weights: Sequence[float] = (0.0,)
    active_data_upper_bound: int | None = None
    active_data_lower_bound: int = 1
    passive_data_lower_bound: int = 0
    shape_budget: int | None = None
