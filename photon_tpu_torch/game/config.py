"""GAME coordinate configurations.

Counterpart of photon_tpu/game/config.py: fixed-effect, random-effect
(index-map, random or identity projection, Pearson feature capping,
bucket caps) and matrix-factorization coordinates.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from photon_tpu_torch.optimize.problem import GLMProblemConfig
from photon_tpu_torch.types import OptimizerType


class ProjectorType(enum.Enum):
    """INDEX_MAP: exact per-entity index compaction; RANDOM: a Gaussian
    random projection; IDENTITY builds like INDEX_MAP."""

    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"
    IDENTITY = "IDENTITY"


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
    on a CUDA device at d ≥ 1024 it is always built. ``bf16_features``
    stores the feature values as bfloat16 (labels, weights, offsets and
    the coefficients stay in the estimator's type, and every product
    accumulates in it)."""

    feature_shard: str
    optimization: GLMProblemConfig
    regularization_weights: Sequence[float] = (0.0,)
    representation: FeatureRepresentation = FeatureRepresentation.AUTO
    column_windows: bool = False
    bf16_features: bool = False

    @property
    def is_random_effect(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """Per-entity GLMs: ``active_data_upper_bound`` caps training rows per
    entity (reservoir sampling), entities below ``active_data_lower_bound``
    get no model, ``passive_data_lower_bound`` drops small passive sets,
    ``features_to_samples_ratio`` caps each entity's columns at that
    multiple of its active rows by Pearson |corr(x, y)|,
    ``projector_type``/``random_projection_dim`` pick the projection,
    ``max_buckets`` forces bucket merges down to that many shapes
    (``PHOTON_RE_MAX_BUCKETS`` overrides, ≤ 0 disables) and
    ``shape_budget`` caps the distinct (rows, d) bucket shapes (None →
    data.DEFAULT_SHAPE_BUDGET, 0 disables)."""

    random_effect_type: str
    feature_shard: str
    optimization: GLMProblemConfig
    regularization_weights: Sequence[float] = (0.0,)
    active_data_upper_bound: int | None = None
    active_data_lower_bound: int = 1
    passive_data_lower_bound: int = 0
    features_to_samples_ratio: float | None = None
    projector_type: ProjectorType = ProjectorType.INDEX_MAP
    random_projection_dim: int | None = None
    max_buckets: int | None = None
    shape_budget: int | None = None

    @property
    def is_random_effect(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationCoordinateConfig:
    """score = ⟨u_row, v_col⟩ between two entity id tags, trained on the
    coordinate-descent residual by one joint L-BFGS over both factor
    tables with λ/2·(‖U‖² + ‖V‖²); factors start at N(0, scale/√k)."""

    row_entity_type: str
    col_entity_type: str
    optimization: GLMProblemConfig
    num_factors: int = 16
    regularization_weights: Sequence[float] = (1.0,)
    init_scale: float = 0.1

    def __post_init__(self):
        opt = self.optimization
        if opt.optimizer not in (OptimizerType.LBFGS,):
            raise ValueError(
                f"matrix factorization trains with LBFGS only (got {opt.optimizer})"
            )
        if opt.regularization.l1_weight(1.0) > 0:
            raise ValueError("matrix factorization supports only L2 regularization")
        if opt.down_sampling_rate != 1.0:
            raise ValueError("matrix factorization does not support down-sampling")
        if self.num_factors < 1:
            raise ValueError("num_factors must be >= 1")

    @property
    def is_random_effect(self) -> bool:
        return False


CoordinateConfig = (
    FixedEffectCoordinateConfig
    | RandomEffectCoordinateConfig
    | MatrixFactorizationCoordinateConfig
)


def required_id_tags(configs) -> set[str]:
    """Entity id-tag columns the coordinates need from training data."""
    tags: set[str] = set()
    for c in configs:
        if isinstance(c, RandomEffectCoordinateConfig):
            tags.add(c.random_effect_type)
        elif isinstance(c, MatrixFactorizationCoordinateConfig):
            tags.add(c.row_entity_type)
            tags.add(c.col_entity_type)
    return tags
