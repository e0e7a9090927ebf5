"""Carry parameters across from the JAX package's arrays, as numpy.

The port imports nothing of photon_tpu; a caller that holds a JAX
``GameModel``, GLM or ``ColumnWindows`` turns its arrays into numpy and
hands them over here, so both packages score (or take a gradient step)
from the same parameters.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from photon_tpu_torch.game.model import (
    BucketCoefficients,
    Coefficients,
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.models.coefficients import Coefficients as GLMCoefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_tpu_torch.ops.sparse_windows import column_windows_from_numpy
from photon_tpu_torch.types import TaskType, resolve_device


def _f64(a):
    return None if a is None else np.asarray(a, dtype=np.float64)


def game_model_from_numpy(task: TaskType, coordinates: Mapping[str, Mapping]) -> GameModel:
    """Build the port's GameModel from per-coordinate numpy arrays.

    Fixed effect: ``{"feature_shard", "means"[, "variances"]}``
    (original space). Random effect: ``{"random_effect_type",
    "feature_shard", "vocab", "num_features"[, "projection_matrix"],
    "buckets": [{"entity_ids", "col_index", "coefficients"[,
    "variances"]}, ...]}``. Matrix factorization: ``{"row_entity_type",
    "col_entity_type", "row_vocab", "col_vocab", "row_factors",
    "col_factors"}``.
    """
    out = {}
    for cid, c in coordinates.items():
        if "means" in c:
            out[cid] = FixedEffectModel(
                coefficients=Coefficients(
                    means=_f64(c["means"]), variances=_f64(c.get("variances"))
                ),
                feature_shard=c["feature_shard"],
                task=task,
            )
        elif "row_factors" in c:
            out[cid] = MatrixFactorizationModel(
                row_entity_type=c["row_entity_type"],
                col_entity_type=c["col_entity_type"],
                row_vocab=np.asarray(c["row_vocab"]),
                col_vocab=np.asarray(c["col_vocab"]),
                row_factors=_f64(c["row_factors"]),
                col_factors=_f64(c["col_factors"]),
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
                        coefficients=_f64(b["coefficients"]),
                        variances=_f64(b.get("variances")),
                    )
                    for b in c["buckets"]
                ),
                num_features=int(c["num_features"]),
                projection_matrix=_f64(c.get("projection_matrix")),
            )
    return GameModel(coordinates=out, task=task)


def glm_from_numpy(
    task: TaskType, means, variances=None, *, device="cuda"
) -> GeneralizedLinearModel:
    """The port's GLM for ``task`` from a model's coefficient means (and
    variances), float64 tensors on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.as_tensor(np.array(a, dtype=np.float64)).to(dev)

    return model_for_task(task, GLMCoefficients(means=t(means), variances=t(variances)))


__all__ = ["game_model_from_numpy", "glm_from_numpy", "column_windows_from_numpy"]
