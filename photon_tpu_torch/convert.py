"""Carry parameters across from the JAX package's arrays, as numpy.

The port imports nothing of photon_tpu; a caller that holds a JAX
``GameModel`` or ``ColumnWindows`` turns its arrays into numpy and hands
them over here, so both packages score (or take a gradient step) from the
same parameters.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from photon_tpu_torch.game.model import (
    BucketCoefficients,
    Coefficients,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.ops.sparse_windows import column_windows_from_numpy
from photon_tpu_torch.types import TaskType


def game_model_from_numpy(task: TaskType, coordinates: Mapping[str, Mapping]) -> GameModel:
    """Build the port's GameModel from per-coordinate numpy arrays.

    Fixed effect: ``{"feature_shard", "means"}`` (original-space means).
    Random effect: ``{"random_effect_type", "feature_shard", "vocab",
    "num_features", "buckets": [{"entity_ids", "col_index",
    "coefficients"}, ...]}``.
    """
    out = {}
    for cid, c in coordinates.items():
        if "means" in c:
            out[cid] = FixedEffectModel(
                coefficients=Coefficients(means=np.asarray(c["means"], dtype=np.float64)),
                feature_shard=c["feature_shard"],
                task=task,
            )
        else:
            out[cid] = RandomEffectModel(
                random_effect_type=c["random_effect_type"],
                feature_shard=c["feature_shard"],
                task=task,
                vocab=np.asarray(c["vocab"]),
                buckets=tuple(
                    BucketCoefficients(
                        entity_ids=np.asarray(b["entity_ids"]),
                        col_index=np.asarray(b["col_index"]),
                        coefficients=np.asarray(b["coefficients"], dtype=np.float64),
                    )
                    for b in c["buckets"]
                ),
                num_features=int(c["num_features"]),
            )
    return GameModel(coordinates=out, task=task)


__all__ = ["game_model_from_numpy", "column_windows_from_numpy"]
