"""Single-GLM training over a regularization-weight grid with warm starts.

Counterpart of photon_tpu/model_training.py (reference
ModelTraining.trainGeneralizedLinearModel, ModelTraining.scala:55,
106-229): one model per λ, each solve warm-started from the previous λ's
coefficients, with normalization, box bounds and variances: the
reference's legacy single-GLM pipeline. The GAME path builds on the same
``GLMProblem`` through coordinate descent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.data.dataset import (
    DataSet,
    choose_sparse,
    to_device_batch,
    to_device_sparse_batch,
)
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optimize.common import OptimizeResult, record_optimize_metrics
from photon_tpu_torch.optimize.problem import GLMProblem, GLMProblemConfig
from photon_tpu_torch.types import LabeledBatch, SparseBatch, resolve_device


@dataclasses.dataclass(frozen=True)
class TrainedModel:
    """One (λ, model, optimization result) row of the output."""

    regularization_weight: float
    model: GeneralizedLinearModel
    result: OptimizeResult
    wall_time_s: float


def train_glm_grid(
    data: DataSet | LabeledBatch | SparseBatch,
    base_config: GLMProblemConfig,
    regularization_weights: Sequence[float],
    *,
    normalization: NormalizationContext = NormalizationContext(),
    warm_start: bool = True,
    initial_coefficients: np.ndarray | torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
    num_features: int | None = None,
    device="cuda",
) -> list[TrainedModel]:
    """Train one GLM per λ in the caller's order, chaining coefficients
    (in the transformed space) from one λ to the next when ``warm_start``.

    A ``DataSet`` is laid out dense or sparse ELL by ``choose_sparse`` and
    placed on ``device`` (a sparse one with the window layout where
    ``windows_wanted`` wants it: on the card at d ≥ 1024). A
    prebuilt ``LabeledBatch``/``SparseBatch`` must already lie on
    ``device``; its dtype wins, and a ``SparseBatch`` needs
    ``num_features``. Runs on the card unless ``device="cpu"``; without a
    card the default raises. Models come back in the original space, with
    variances when the config asks for them. Each λ point's solve is the
    span ``glm.fit``."""
    dev = resolve_device(device)
    if isinstance(data, (LabeledBatch, SparseBatch)):
        batch = data
        use_sparse = isinstance(data, SparseBatch)
        if use_sparse and num_features is None:
            raise ValueError("num_features is required with a SparseBatch")
        if batch.labels.device.type != dev.type:
            raise ValueError(f"the batch lies on {batch.labels.device}, not on {dev}")
        d = num_features if use_sparse else batch.features.shape[-1]
        dtype = batch.values.dtype if use_sparse else batch.features.dtype
    else:
        itemsize = torch.empty((), dtype=dtype).element_size()
        use_sparse = choose_sparse(
            data.num_samples, data.num_features, len(data.values), itemsize
        )

        def place(ds: DataSet):
            to_device = to_device_sparse_batch if use_sparse else to_device_batch
            return to_device(ds, dtype=dtype, device=dev)

        batch = place(data)
        d = data.num_features
    normalization = normalization.to(dev, dtype)

    if initial_coefficients is None:
        w = torch.zeros(d, dtype=dtype, device=dev)
    elif isinstance(initial_coefficients, torch.Tensor):
        w = initial_coefficients.to(device=dev, dtype=dtype)
    else:
        w = torch.as_tensor(np.array(initial_coefficients)).to(device=dev, dtype=dtype)
    w = normalization.model_to_transformed_space(w)

    results: list[TrainedModel] = []
    for reg_weight in regularization_weights:
        problem = GLMProblem.build(
            base_config.with_regularization_weight(reg_weight), normalization
        )
        sampler = problem.down_sampler()
        solve_batch = batch
        if sampler is not None and isinstance(data, DataSet):
            solve_batch = place(sampler.downsample(data))

        t0 = time.perf_counter()
        with obs.span("glm.fit", cat="solver", regularization_weight=reg_weight):
            result = problem.solve(solve_batch, w)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        # the solve's work counters into telemetry (after its sync)
        record_optimize_metrics(result)

        variances = problem.variances(batch, result.x)
        if variances is not None and normalization.factors is not None:
            # variances scale with the square of the factors
            variances = variances * normalization.factors * normalization.factors
        model = model_for_task(
            base_config.task,
            Coefficients(
                means=normalization.model_to_original_space(result.x), variances=variances
            ),
        )
        results.append(
            TrainedModel(
                regularization_weight=reg_weight, model=model, result=result, wall_time_s=wall
            )
        )
        if warm_start:
            w = result.x
    return results
